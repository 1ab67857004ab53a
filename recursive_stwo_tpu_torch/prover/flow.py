"""The port's proving flow: one stage sequence for every prover.

Twin of the JAX package's four flows (recursive_stwo_tpu/prover/
device_prove.py::prove_device :630-861, prove_np.py::prove_np :158-272,
stream.py's `prove_streamed` and `prove_np_streamed`): the same stages in
the same order with the same channel mixing, so every proof is
byte-identical to the JAX package's.  `prove_air` runs the protocol once,
from the trace upload through the OODS samples and the first-layer
quotients to `fri.fri_tail`, over two seams:

- the AIR: `PoseidonAir` (PlonkWithPoseidon, the plonk table then the
  poseidon table) or `NoPoseidonAir` (PlonkWithoutPoseidon, the last layer's
  one table).  It gives its tables' columns on the device, its spec, each
  table's evaluator, its samples layout and its proof container.
- the commitment: `Resident(tree_cls)` here, the LDEs held in `tree_cls`
  trees, or prover/stream.py's `Streamed`, the trees streamed over base
  coefficients.  It commits a tree from base coefficients, names the
  blocks the first-layer quotients read, takes those quotients, and makes
  the FRI layers' trees.

The channel and its tree class are the flavour's (`prove.flavour`).  Each
tree's coefficients are interpolated just before it is committed.  Each
stage ends with a `progress` message, which the benchmark times: "trace
uploaded (...)", "tree0 (preprocessed) committed", "tree1 (trace)
committed", "interaction columns generated", "tree2 (interaction)
committed", "composition coefficients computed", "tree3 (composition)
committed", "OODS samples computed", then, streamed, "quotients at log L
streamed" for each first-layer group, then fri_tail's own.

On CUDA every interpolation and LDE is the circle FFT kernel
(prover/circle_fft.py), each table's interaction columns one launch of the
interaction kernel (prover/interaction.py), the composition the domain
kernel (prover/composition.py), the OODS samples of every block and point
one launch of the sampling kernel (prover/sample.py), and each first-layer
group's quotients one call of the quotient kernel (prover/quotients.py).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..core import circle_host as ccircle
from ..proof.containers import PlonkWithoutPoseidonProof, PlonkWithPoseidonProof
from ..utils.spans import span
from ..verifier import composition as vcomp
from ..verifier.spec import PLONK_LOG_EXPAND, POSEIDON_LOG_EXPAND, NoPoseidonVerifierSpec, VerifierSpec
from . import circle_fft, sample
from .air import coset_to_domain_perm, np_columns
from .arrays import to_device, trace_to_torch
from .commit import merge_by_log
from .composition import composition_stage, qm31_scalar
from .fri import _mix_felts, fri_tail
from .interaction import interaction_columns
from .prove_host import _add_const, _assemble_samples, _assemble_samples_np, _oods_point
from .quotients import quotients_stage


def _domain_order(rows: torch.Tensor, log_size: int) -> torch.Tensor:
    """Row-order columns -> bit-reversed circle-domain order."""
    return rows[..., to_device(coset_to_domain_perm(log_size), rows.device)]


class PoseidonAir:
    """PlonkWithPoseidon: the plonk table, then the poseidon table."""

    evaluators = (vcomp.evaluate_plonk, vcomp.evaluate_poseidon)

    def upload(self, trace: dict, device):
        """([(preprocessed, trace) columns of each table], [each table's log
        size]), the columns in row order on `device`."""
        ta = trace_to_torch(trace, device)
        return [(ta.plonk_pre, ta.plonk_tr), (ta.pos_pre, ta.pos_tr)], [ta.log_plonk, ta.log_poseidon]

    def spec(self, logs, config) -> VerifierSpec:
        lp, lq = logs
        fri = config.fri_config
        spec = VerifierSpec(
            log_size_plonk=lp,
            log_size_poseidon=lq,
            pow_bits=config.pow_bits,
            log_last_layer_degree_bound=fri.log_last_layer_degree_bound,
            log_blowup_factor=fri.log_blowup_factor,
            n_queries=fri.n_queries,
            n_inner_layers=max(lp + PLONK_LOG_EXPAND, lq + POSEIDON_LOG_EXPAND) - 2 - fri.log_last_layer_degree_bound,
        )
        if spec.n_inner_layers != spec.expected_n_inner_layers:
            raise ValueError("the FRI config does not fit the trace's log sizes")
        return spec

    def key(self, tree: int, table: int):
        """The samples layout's key of a tree's block of one table."""
        return (tree, "c") if tree == 3 else (tree, "pq"[table])

    def assemble(self, spec, logs, bound, samples_at):
        return _assemble_samples(spec, *logs, bound, samples_at)

    def proof(self, logs, totals, config, stark_proof) -> PlonkWithPoseidonProof:
        return PlonkWithPoseidonProof(
            log_size_plonk=logs[0],
            log_size_poseidon=logs[1],
            plonk_total_sum=np.array(totals[0], np.uint32),
            poseidon_total_sum=np.array(totals[1], np.uint32),
            config=config,
            stark_proof=stark_proof,
        )


class NoPoseidonAir:
    """PlonkWithoutPoseidon (the last-layer output AIR): one table."""

    evaluators = (vcomp.evaluate_plonk_np,)

    def upload(self, trace: dict, device):
        with span("prove.air"):
            pre, tr = np_columns(trace)
        L = pre.shape[1].bit_length() - 1
        if 1 << L != pre.shape[1]:
            raise ValueError(f"{pre.shape[1]} rows is not a power of two")
        with span("prove.upload"):
            return [(to_device(pre, device), to_device(tr, device))], [L]

    def spec(self, logs, config) -> NoPoseidonVerifierSpec:
        return NoPoseidonVerifierSpec.for_rows(logs[0], config)

    def key(self, tree: int, table: int):
        return tree

    def assemble(self, spec, logs, bound, samples_at):
        return _assemble_samples_np(spec, bound, samples_at)

    def proof(self, logs, totals, config, stark_proof) -> PlonkWithoutPoseidonProof:
        return PlonkWithoutPoseidonProof(
            log_size=logs[0], total_sum=np.array(totals[0], np.uint32), config=config, stark_proof=stark_proof
        )


class Resident:
    """Trees of `tree_cls` over every block's LDE, held until the proof ends;
    the first-layer quotients read the trees' columns in place, and the FRI
    layers' trees are `tree_cls` too."""

    def __init__(self, tree_cls):
        self.tree_cls = self.layer_tree = tree_cls

    def commit(self, blocks):
        """[(LDE log, base coefficients), ...] -> the tree of their LDEs,
        blocks of one log merged in call order."""
        return self.tree_cls(merge_by_log([(L, circle_fft.lde(c, L)) for L, c in blocks]))

    @staticmethod
    def columns(tree) -> dict:
        return tree.columns_by_log

    def quotients(self, spec, blocks_by_log, samples_flat, oods, after_coeff, plog):
        return quotients_stage(spec, blocks_by_log, samples_flat, oods, after_coeff)


def prove_air(air, commitment, trace: dict, config, progress, device, channel):
    """Prove `trace` of `air` on `device` through `commitment`; `channel` is
    a fresh prover channel, `progress` (if given) is called with a message
    after each stage."""
    plog = progress or logging.getLogger(__name__).debug
    blowup = config.fri_config.log_blowup_factor
    columns, logs = air.upload(trace, device)
    spec = air.spec(logs, config)
    bound = spec.composition_log_degree_bound
    plog(f"trace uploaded (log sizes {'/'.join(map(str, logs))}, composition bound {bound})")

    def interpolate(rows):
        return [circle_fft.interpolate(_domain_order(r, L)) for r, L in zip(rows, logs)]

    def commit(blocks):
        return commitment.commit([(c.shape[1].bit_length() - 1 + blowup, c) for c in blocks])

    # coeffs[t][i]: tree t's base coefficients of table i
    coeffs = [interpolate([pre for pre, _ in columns])]
    tree0 = commit(coeffs[0])
    channel.mix_root(tree0.root)
    plog("tree0 (preprocessed) committed")
    for L in logs:
        channel.mix_one_felt([L, 0, 0, 0])
    coeffs.append(interpolate([tr for _, tr in columns]))
    tree1 = commit(coeffs[1])
    channel.mix_root(tree1.root)
    plog("tree1 (trace) committed")

    z4, alpha4 = channel.draw_felts()
    lookup = (qm31_scalar(z4), qm31_scalar(alpha4))
    with span("prove.interaction"):
        inter, totals = zip(
            *(interaction_columns(pre, tr, lookup, ev) for (pre, tr), ev in zip(columns, air.evaluators))
        )
        coeffs.append(interpolate(inter))
    del columns, inter
    plog("interaction columns generated")
    _mix_felts(channel, totals)
    tree2 = commit(coeffs[2])
    channel.mix_root(tree2.root)
    plog("tree2 (interaction) committed")

    random_coeff4 = channel.draw_felt()
    with span("prove.composition"):
        split = composition_stage(
            spec,
            tuple(
                ((pre, tr, it), qm31_scalar(total), L, ev)
                for pre, tr, it, total, L, ev in zip(*coeffs, totals, logs, air.evaluators)
            ),
            lookup,
            qm31_scalar(random_coeff4),
        )
    plog("composition coefficients computed")
    tree3 = commit([split])
    channel.mix_root(tree3.root)
    plog("tree3 (composition) committed")

    # ---- OODS samples (device sums, host factors), one sampling call ----
    oods = _oods_point(channel.draw_felt())
    coeffs.append([split])
    samples_at = sample.samples_at(
        {air.key(t, i): c for t, blocks in enumerate(coeffs) for i, c in enumerate(blocks)},
        oods,
        {air.key(2, i): _add_const(oods, ccircle.point_neg(ccircle.CanonicCoset(L).step())) for i, L in enumerate(logs)},
    )
    del coeffs, split
    sampled_values = air.assemble(spec, logs, bound, samples_at)
    plog("OODS samples computed")
    _mix_felts(channel, [s for tree in sampled_values for col in tree for s in col])

    # ---- FRI first layer: quotients on the commitment domains ----
    after_coeff4 = channel.draw_felt()
    trees = [tree0, tree1, tree2, tree3]
    # group column order is spec.group_columns': tree-major within each log,
    # plonk before poseidon inside a merged block
    blocks_by_log = {}
    for tree in trees:
        for log, block in commitment.columns(tree).items():
            blocks_by_log.setdefault(log, []).append(block)
    samples_flat = np.concatenate([col for tree in sampled_values for col in tree]).astype(np.uint32)
    first_cols = commitment.quotients(spec, blocks_by_log, samples_flat, oods, after_coeff4, plog)
    del blocks_by_log

    stark_proof = fri_tail(spec, config, channel, trees, first_cols, sampled_values, plog, commitment.layer_tree)
    return air.proof(logs, totals, config, stark_proof)
