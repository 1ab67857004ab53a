"""Inputs of the composition kernels at the port's shapes, for the tests,
chip_smoke.py and tools/kernel_times.py.

  check_case(name, batch, device, corrupt_slot=None) -> CheckCase
      the composition check's inputs of one of CHECK_FIXTURES (each
      verifier's fixture or artifact), from its own transcript run once on
      the CPU at batch 1, tiled to `batch` proofs on `device`;
      `corrupt_slot` adds one to a sampled value of that slot
  random_check_case(spec, batch, seed, device) -> CheckCase
      random canonical samples, total sums, lookup elements, random_coeff
      and OODS point (so every constraint is nonzero)
  prover_tables(trace, config, device, without_poseidon=False)
      -> (spec, tables, lookup, random_coeff): what `prove` (`prove_np`)
      hands its composition stage for `trace`: the proof runs on `device` up
      to that stage and stops there
  check_value(case, plain=False) -> ((B,) bool, (B,) QM31)
      the check on a case: composition_value[_np], or the plain version
  domain_calls(spec, tables) -> [DomainCall]
      each table's domain-kernel inputs (its LDE blocks made once, held)
  run_domain(call, acc, lookup, random_coeff, plain=False)
      one table's evaluation into acc (4, N): the domain kernel, or the
      plain version (its _ProverEval into a HornerSink started from acc)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.qm31 import QM31
from ..models import flagship
from ..prover import composition as pcomp
from ..verifier import composition as vcomp
from ..verifier import points, transcript
from ..verifier.arrays import to_torch
from ..verifier.spec import NoPoseidonVerifierSpec

P = 2**31 - 1
# the fixtures of verify_batch, verify_batch_np and the SHA-256 flavours
CHECK_FIXTURES = ("small_proof", "recursive_proof_16_15", "np_small", "level14", "bitcoin")


class CheckCase(NamedTuple):
    spec: object
    samples_flat: torch.Tensor  # (B, S, 4)
    sums: tuple  # the components' total sums
    lookup: tuple  # (z, alpha)
    random_coeff: QM31
    oods: tuple  # (x, y)


def _q_cols(arr) -> QM31:
    return QM31(*(arr[:, i] for i in range(4)))


def _tq(x) -> QM31:
    return QM31(*(torch.from_numpy(np.asarray(c).astype(np.int64).reshape(-1)) for c in x))


def _batch1(name: str) -> CheckCase:
    """A fixture's inputs at batch 1 on the CPU."""
    if name in ("level14", "bitcoin"):
        spec, pa, fs = flagship.sha_prepared(name)
        pa = to_torch(pa, "cpu")
        sums = (_q_cols(pa.plonk_total_sum),) + (() if name == "bitcoin" else (_q_cols(pa.poseidon_total_sum),))
        return CheckCase(spec, pa.samples_flat, sums, (_tq(fs.z), _tq(fs.alpha)), _tq(fs.random_coeff),
                         points.oods_point_from_t(_tq(fs.oods_t)))
    if name == "np_small":
        spec, pa = flagship.prepared_arrays_np(name)
        pa = to_torch(pa, "cpu")
        fs = transcript.run_transcript_np(spec, pa)
        sums = (_q_cols(pa.plonk_total_sum),)
    else:
        spec, pa = flagship.prepared_arrays(name)
        pa = to_torch(pa, "cpu")
        fs = transcript.run_transcript(spec, pa)
        sums = (_q_cols(pa.plonk_total_sum), _q_cols(pa.poseidon_total_sum))
    return CheckCase(spec, pa.samples_flat, sums, (fs.z, fs.alpha), fs.random_coeff,
                     points.oods_point_from_t(fs.oods_t))


def _tile(case: CheckCase, batch: int, device) -> CheckCase:
    def q(x: QM31) -> QM31:
        return QM31(*(c.reshape(-1).expand(batch).contiguous().to(device) for c in x))

    return CheckCase(
        case.spec, case.samples_flat.expand(batch, -1, -1).contiguous().to(device),
        tuple(q(s) for s in case.sums), tuple(q(v) for v in case.lookup), q(case.random_coeff),
        tuple(q(v) for v in case.oods),
    )


def check_case(name: str, batch: int, device, corrupt_slot=None) -> CheckCase:
    if name not in CHECK_FIXTURES:
        raise ValueError(f"unknown fixture {name!r}, expected one of {CHECK_FIXTURES}")
    case = _tile(_batch1(name), batch, device)
    if corrupt_slot is not None:
        s = case.samples_flat
        s[corrupt_slot, 0, 0] = (s[corrupt_slot, 0, 0] + 1) % P
    return case


def random_check_case(spec, batch: int, seed: int, device) -> CheckCase:
    rng = np.random.default_rng(seed)

    def q() -> QM31:
        return QM31(*(torch.from_numpy(rng.integers(0, P, batch)).to(device) for _ in range(4)))

    n_sums = 1 if isinstance(spec, NoPoseidonVerifierSpec) else 2
    samples = torch.from_numpy(rng.integers(0, P, (batch, spec.total_samples, 4))).to(device)
    return CheckCase(spec, samples, tuple(q() for _ in range(n_sums)), (q(), q()), q(), (q(), q()))


def check_value(case: CheckCase, plain: bool = False) -> tuple:
    """((B,) bool, (B,) QM31) of a case: composition_value[_np] (the check
    kernel on a CUDA case), or with `plain` the plain version."""
    if plain:
        return vcomp.composition_value_plain(
            case.spec, case.samples_flat, case.sums, case.lookup, case.random_coeff, case.oods
        )
    fn = vcomp.composition_value_np if len(case.sums) == 1 else vcomp.composition_value
    return fn(case.spec, case.samples_flat, *case.sums, case.lookup, case.random_coeff, case.oods)


class _Stop(Exception):
    pass


def prover_tables(trace: dict, config, device, without_poseidon: bool = False) -> tuple:
    """(spec, tables, lookup, random_coeff) of the composition stage of
    `prove` (or, `without_poseidon`, of `prove_np`) for `trace` on `device`:
    the stages before it run, the stage itself is replaced by a capture that
    ends the proof."""
    from ..prover import flow
    from ..prover.prove import prove
    from ..prover.prove_np import prove_np

    prove_fn = prove_np if without_poseidon else prove
    got = []

    def capture(spec, tables, lookup, random_coeff):
        got.append((spec, tables, lookup, random_coeff))
        raise _Stop

    stage = flow.composition_stage
    flow.composition_stage = capture
    try:
        prove_fn(trace, config, device=device)
    except _Stop:
        pass
    finally:
        flow.composition_stage = stage
    return got[0]


class DomainCall(NamedTuple):
    evaluate_fn: object
    pre: torch.Tensor
    tr: torch.Tensor
    inter: torch.Tensor
    perm: torch.Tensor
    denom_inv: torch.Tensor
    first: bool
    total: QM31
    log: int


def domain_calls(spec, tables) -> list:
    calls = []

    def keep(i, evaluate_fn, pre, tr, inter, perm, total, denom_inv, log):
        calls.append(DomainCall(evaluate_fn, pre, tr, inter, perm, denom_inv, i == 0, total, log))

    pcomp.each_table(spec, tables, keep)
    return calls


def run_domain(call: DomainCall, acc: torch.Tensor, lookup, random_coeff, plain: bool = False) -> torch.Tensor:
    """acc after one table's evaluation (in place for the kernel)."""
    if not plain:
        from ..ops import composition_cuda

        composition_cuda.domain(call.evaluate_fn, call.pre, call.tr, call.inter, call.perm, call.denom_inv, acc,
                                call.first, call.total, lookup, random_coeff, call.log)
        return acc
    sink = vcomp.HornerSink(random_coeff, acc.shape[-1])
    sink.acc = None if call.first else QM31(*acc)
    ev = pcomp._ProverEval(call.pre, call.tr, call.inter, call.perm, call.total, call.denom_inv, call.log, sink)
    call.evaluate_fn(ev, lookup)
    return torch.stack(list(sink.acc))
