"""The device-resident PlonkWithPoseidon prover.

Twin of recursive_stwo_tpu/prover/device_prove.py::prove_device (:630-861):
the same stages in the same order with the same channel mixing, so the
proof is byte-identical to the JAX package's.  One code path at every size:
the JAX package's fused-stage programs and its per-table split for large
domains (`RSTPU_DEVICE_BIG_LOG`, :668-675) exist to fit a TPU's HBM or XLA's
fusion and have no counterpart here.  On CUDA every Merkle level of a
Poseidon31 tree runs on one launch of the Merkle level kernel
(prover/commit.py), each FRI layer's folds on one launch of the fold-layer
kernel (prover/fri.py), the PoW grind at 22 bits or more on kernel K1, every
interpolation and LDE on the circle FFT kernel (prover/circle_fft.py),
each table's interaction columns on one launch of the interaction kernel
(prover/interaction.py), the OODS samples of every block and point on one
launch of the sampling kernel (prover/sample.py) and each first-layer
group's quotients on one call of the quotient kernel (prover/quotients.py),
its columns read in place from the trees.

The channel and the tree class are parameters, as they are in the JAX
package's host flow (prove.py:164-208, `_fri_tail(tree_cls=)`): the
Poseidon31 channel with `DeviceTree`, or `Sha256ProverChannel` with
`Sha256DeviceTree` for the Sha256Poseidon31 flavour.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..core import circle_host as ccircle
from ..proof.containers import PcsConfig, PlonkWithPoseidonProof
from ..verifier import composition as vcomp
from ..verifier.spec import PLONK_LOG_EXPAND, POSEIDON_LOG_EXPAND, VerifierSpec
from . import air, circle_fft, sample
from .arrays import to_device, trace_to_torch
from .commit import merge_by_log
from .composition import composition_stage, qm31_scalar
from .fri import _mix_felts, fri_tail
from .interaction import interaction_columns
from .prove_host import _add_const, _assemble_samples, _oods_point
from .quotients import quotients_stage


def _domain_order(rows: torch.Tensor, log_size: int) -> torch.Tensor:
    """Row-order columns -> bit-reversed circle-domain order."""
    return rows[..., to_device(air.coset_to_domain_perm(log_size), rows.device)]


def prove_device(trace: dict, config: PcsConfig, progress, device, channel, tree_cls) -> PlonkWithPoseidonProof:
    """`channel` is a fresh prover channel and `tree_cls` the Merkle tree
    class of its flavour (`prove.flavour`)."""
    device = torch.device(device)
    plog = progress or logging.getLogger(__name__).debug
    blowup = config.fri_config.log_blowup_factor

    # ---- AIR columns (host, row order), uploaded once ----
    ta = trace_to_torch(trace, device)
    lp, lq = ta.log_plonk, ta.log_poseidon
    bound = max(lp + PLONK_LOG_EXPAND, lq + POSEIDON_LOG_EXPAND)
    spec = VerifierSpec(
        log_size_plonk=lp,
        log_size_poseidon=lq,
        pow_bits=config.pow_bits,
        log_last_layer_degree_bound=config.fri_config.log_last_layer_degree_bound,
        log_blowup_factor=blowup,
        n_queries=config.fri_config.n_queries,
        n_inner_layers=bound - 2 - config.fri_config.log_last_layer_degree_bound,
    )
    if spec.n_inner_layers != spec.expected_n_inner_layers:
        raise ValueError("the FRI config does not fit the trace's log sizes")
    plog(f"trace uploaded (log sizes {lp}/{lq}, composition bound {bound})")

    # ---- trees 0 + 1 (no channel draw between them) ----
    coeffs, ldes = {}, {}
    for key, rows, log in (
        ("p_pre", ta.plonk_pre, lp),
        ("p_tr", ta.plonk_tr, lp),
        ("q_pre", ta.pos_pre, lq),
        ("q_tr", ta.pos_tr, lq),
    ):
        coeffs[key] = circle_fft.interpolate(_domain_order(rows, log))
        ldes[key] = circle_fft.lde(coeffs[key], log + blowup)
    tree0 = tree_cls(merge_by_log([(lp + blowup, ldes["p_pre"]), (lq + blowup, ldes["q_pre"])]))
    tree1 = tree_cls(merge_by_log([(lp + blowup, ldes["p_tr"]), (lq + blowup, ldes["q_tr"])]))
    del ldes  # the trees hold the LDEs (merged into one block per log when lp == lq)
    channel.mix_root(tree0.root)
    plog("tree0 (preprocessed) committed")
    channel.mix_one_felt([lp, 0, 0, 0])
    channel.mix_one_felt([lq, 0, 0, 0])
    channel.mix_root(tree1.root)
    plog("tree1 (trace) committed")

    z4, alpha4 = channel.draw_felts()
    lookup = (qm31_scalar(z4), qm31_scalar(alpha4))

    # ---- interaction columns + tree 2 ----
    int_p, plonk_total = interaction_columns(ta.plonk_pre, ta.plonk_tr, lookup, vcomp.evaluate_plonk)
    int_q, pos_total = interaction_columns(ta.pos_pre, ta.pos_tr, lookup, vcomp.evaluate_poseidon)
    c_int_p = circle_fft.interpolate(_domain_order(int_p, lp))
    c_int_q = circle_fft.interpolate(_domain_order(int_q, lq))
    del ta, int_p, int_q
    plog("interaction columns generated")
    channel.mix_two_felts(plonk_total, pos_total)
    tree2 = tree_cls(
        merge_by_log(
            [(lp + blowup, circle_fft.lde(c_int_p, lp + blowup)), (lq + blowup, circle_fft.lde(c_int_q, lq + blowup))]
        )
    )
    channel.mix_root(tree2.root)
    plog("tree2 (interaction) committed")

    random_coeff4 = channel.draw_felt()

    # ---- composition polynomial + tree 3 ----
    split_coeffs = composition_stage(
        spec,
        (
            ((coeffs["p_pre"], coeffs["p_tr"], c_int_p), qm31_scalar(plonk_total), lp, vcomp.evaluate_plonk),
            ((coeffs["q_pre"], coeffs["q_tr"], c_int_q), qm31_scalar(pos_total), lq, vcomp.evaluate_poseidon),
        ),
        lookup,
        qm31_scalar(random_coeff4),
    )
    plog("composition evals computed")
    tree3 = tree_cls({bound - 1 + blowup: circle_fft.lde(split_coeffs, bound - 1 + blowup)})
    channel.mix_root(tree3.root)
    plog("tree3 (composition) committed")

    oods = _oods_point(channel.draw_felt())

    # ---- OODS samples (device sums, host factors), one sampling call ----
    col_coeffs = {
        (0, "p"): coeffs["p_pre"],
        (0, "q"): coeffs["q_pre"],
        (1, "p"): coeffs["p_tr"],
        (1, "q"): coeffs["q_tr"],
        (2, "p"): c_int_p,
        (2, "q"): c_int_q,
        (3, "c"): split_coeffs,
    }
    shifted = {log: _add_const(oods, ccircle.point_neg(ccircle.CanonicCoset(log).step())) for log in (lp, lq)}
    samples_at = sample.samples_at(col_coeffs, oods, {(2, "p"): shifted[lp], (2, "q"): shifted[lq]})
    del coeffs, col_coeffs, c_int_p, c_int_q, split_coeffs
    sampled_values = _assemble_samples(spec, lp, lq, bound, samples_at)
    plog("OODS samples computed")
    _mix_felts(channel, [s for tree in sampled_values for col in tree for s in col])

    after_coeff4 = channel.draw_felt()

    # ---- FRI first layer: quotients on the commitment domains ----
    # group column order is spec.group_columns': tree-major within each log,
    # plonk before poseidon inside a merged block
    trees = [tree0, tree1, tree2, tree3]
    blocks_by_log = {}
    for tree in trees:
        for log, block in tree.columns_by_log.items():
            blocks_by_log.setdefault(log, []).append(block)
    samples_flat = np.concatenate([col for tree in sampled_values for col in tree]).astype(np.uint32)
    first_cols = quotients_stage(spec, blocks_by_log, samples_flat, oods, after_coeff4)
    del blocks_by_log

    stark_proof = fri_tail(spec, config, channel, trees, first_cols, sampled_values, plog, tree_cls)
    return PlonkWithPoseidonProof(
        log_size_plonk=lp,
        log_size_poseidon=lq,
        plonk_total_sum=np.array(plonk_total, np.uint32),
        poseidon_total_sum=np.array(pos_total, np.uint32),
        config=config,
        stark_proof=stark_proof,
    )
