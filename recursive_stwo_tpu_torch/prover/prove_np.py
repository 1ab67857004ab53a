"""The device-resident PlonkWithoutPoseidon prover (the last-layer output AIR).

Twin of recursive_stwo_tpu/prover/prove_np.py::prove_np, its host flow
(:158-272): one table at one log size, the same channel mixing and the same
FRI tail, so the proof is byte-identical to the JAX package's.  Its helpers
map onto the stages the PlonkWithPoseidon prover already runs on tensors:

- columns: `air.np_columns`, uploaded once (the `prove.air` and
  `prove.upload` spans, as in `arrays.trace_to_torch`);
- interaction: `interaction.interaction_columns` with the verifier's
  `evaluate_plonk_np`;
- composition (`_composition_evals_np`): `composition_stage` with one table;
- samples: `sample.samples_at` (one sampling call), laid out by
  `_assemble_samples_np` (copied);
- quotients (`_group_quotients_np`): `quotients_stage` on
  `NoPoseidonVerifierSpec`'s groups (on CUDA the quotient kernel, once a
  group; the transforms on the circle FFT kernel);
- the FRI tail: `fri_tail`.

`channel` / `tree_cls` pick the flavour as `prove` does: the Poseidon31
default, or (`Sha256ProverChannel()`, `Sha256DeviceTree`) for the bitcoin
proof's Sha256MerkleChannel flavour (examples/last_layer.py:150-155).
Like `prove`, it never routes by domain size to the streamed flow
(prove_np.py:149-155 in the JAX package): that is prover/stream.py's
`prove_np_streamed`, called by name.
"""

from __future__ import annotations

import logging

import numpy as np

from ..core import circle_host as ccircle
from ..proof.containers import PcsConfig, PlonkWithoutPoseidonProof
from ..utils.spans import span
from ..verifier import composition as vcomp
from ..verifier.arrays import require_device
from ..verifier.spec import NoPoseidonVerifierSpec
from . import air, circle_fft, sample
from .arrays import to_device
from .composition import composition_stage, qm31_scalar
from .device_prove import _domain_order
from .fri import _mix_felts, fri_tail
from .interaction import interaction_columns
from .prove import flavour
from .prove_host import _add_const, _oods_point
from .quotients import quotients_stage


def _assemble_samples_np(spec, bound, samples_at):
    """Copied from prover/prove_np.py:82-96: TreeVec[tree][col] ->
    (n_samples, 4) arrays in proof order."""
    sampled = []
    for t in range(3):
        cols = samples_at[(t, 0)]
        tree_cols = []
        for ci in range(cols.shape[0]):
            if spec.n_samples_per_column[t][ci] == 1:
                tree_cols.append(cols[ci][None, :])
            else:
                prev = samples_at[(t, -1)][ci]
                tree_cols.append(np.stack([prev, cols[ci]]))
        sampled.append(tree_cols)
    comp = samples_at[(3, 0)]
    sampled.append([comp[ci][None, :] for ci in range(8)])
    return sampled


def prove_np(
    trace: dict,
    config: PcsConfig,
    progress=None,
    device="cuda",
    channel=None,
    tree_cls=None,
) -> PlonkWithoutPoseidonProof:
    """Prove a PlonkWithoutPoseidonCS trace (`cs.generate_trace()`) on
    `device`.  `progress`, if given, is called with a message after each
    stage."""
    device = require_device(device)
    channel, Tree = flavour(channel, tree_cls, device)
    plog = progress or logging.getLogger(__name__).debug

    with span("prove.air"):
        pre_h, tr_h = air.np_columns(trace)
    L = pre_h.shape[1].bit_length() - 1
    if 1 << L != pre_h.shape[1]:
        raise ValueError(f"{pre_h.shape[1]} rows is not a power of two")
    blowup = config.fri_config.log_blowup_factor
    spec = NoPoseidonVerifierSpec.for_rows(L, config)
    bound = spec.composition_log_degree_bound
    with span("prove.upload"):
        pre, tr = to_device(pre_h, device), to_device(tr_h, device)
    del pre_h, tr_h
    plog(f"trace uploaded (log size {L}, composition bound {bound})")

    c_pre = circle_fft.interpolate(_domain_order(pre, L))
    tree0 = Tree({L + blowup: circle_fft.lde(c_pre, L + blowup)})
    channel.mix_root(tree0.root)
    plog("tree0 (preprocessed) committed")
    channel.mix_one_felt([L, 0, 0, 0])

    c_tr = circle_fft.interpolate(_domain_order(tr, L))
    tree1 = Tree({L + blowup: circle_fft.lde(c_tr, L + blowup)})
    channel.mix_root(tree1.root)
    plog("tree1 (trace) committed")

    z4, alpha4 = channel.draw_felts()
    lookup = (qm31_scalar(z4), qm31_scalar(alpha4))
    inter, total = interaction_columns(pre, tr, lookup, vcomp.evaluate_plonk_np)
    c_int = circle_fft.interpolate(_domain_order(inter, L))
    del pre, tr, inter
    plog("interaction columns generated")
    channel.mix_one_felt(total)
    tree2 = Tree({L + blowup: circle_fft.lde(c_int, L + blowup)})
    channel.mix_root(tree2.root)
    plog("tree2 (interaction) committed")

    random_coeff4 = channel.draw_felt()
    split_coeffs = composition_stage(
        spec,
        (((c_pre, c_tr, c_int), qm31_scalar(total), L, vcomp.evaluate_plonk_np),),
        lookup,
        qm31_scalar(random_coeff4),
    )
    plog("composition evals computed")
    tree3 = Tree({bound - 1 + blowup: circle_fft.lde(split_coeffs, bound - 1 + blowup)})
    channel.mix_root(tree3.root)
    plog("tree3 (composition) committed")

    oods = _oods_point(channel.draw_felt())
    shifted = _add_const(oods, ccircle.point_neg(ccircle.CanonicCoset(L).step()))
    samples_at = sample.samples_at(dict(enumerate((c_pre, c_tr, c_int, split_coeffs))), oods, {2: shifted})
    del c_pre, c_tr, c_int, split_coeffs
    sampled_values = _assemble_samples_np(spec, bound, samples_at)
    plog("OODS samples computed")
    _mix_felts(channel, [s for tree in sampled_values for col in tree for s in col])

    after_coeff4 = channel.draw_felt()

    # group column order is spec.group_columns': tree-major within each log
    trees = [tree0, tree1, tree2, tree3]
    blocks_by_log = {}
    for tree in trees:
        for log, block in tree.columns_by_log.items():
            blocks_by_log.setdefault(log, []).append(block)
    samples_flat = np.concatenate([col for tree in sampled_values for col in tree]).astype(np.uint32)
    first_cols = quotients_stage(spec, blocks_by_log, samples_flat, oods, after_coeff4)
    del blocks_by_log

    stark_proof = fri_tail(spec, config, channel, trees, first_cols, sampled_values, plog, Tree)
    return PlonkWithoutPoseidonProof(
        log_size=L,
        total_sum=np.array(total, np.uint32),
        config=config,
        stark_proof=stark_proof,
    )
