"""Device times of the port's hand-written kernels on CUDA, beside their bounds.

    python recursive_stwo_tpu_torch/tools/kernel_times.py [--root DIR] [--label NAME]

Imports recursive_stwo_tpu_torch from DIR (default: the checkout holding this
script), so that two checkouts can be timed in one process on one card, and
times, at the shapes the port calls them with:
  K1 (permute_rows): (1024, 16), a transcript step; 2**12 to 2**23 rows
     (channel.grind_device, the grind kernel's plain version, permutes
     blocks of 2**22; the provers' Merkle
     levels ran on K1 at these sizes before the Merkle level kernel, and
     still do in a parent checkout).  Each of K1's schedules
     separately where the checkout has more than one, and the one
     permute_rows picks ("auto").
  K2 (permute_wordmajor): (4, 16, 16384), a hash step; (4, 16, 2**18).
  The scan (wordmajor_scan), where the checkout has it: the absorb and the
     walk pass of one verify_batch at B=1024 of each fixture, and the same
     passes of small_proof at B=2**14 run over their first N = 2**12 .. 2**18
     slots; beside it K2 at its main-path shape, the leaf step (W, 16, B*Q).
  The composition kernels, where the checkout has them: the check kernel
     (composition_check) at B=1024 on small_proof, recursive_proof_16_15
     and np_small, at np_small's B=512 and at the SHA fast paths' batch 1
     (level 14, bitcoin), beside its latency floor where the checkout has
     one; the domain kernel (composition_domain) on each table of chain
     levels 1 and 2 (the tables `prove` hands its composition stage) and
     on a without-Poseidon table of random rows at their 2**21 points, first
     and accumulating, beside the plain version's time on the card.
  The fold kernel (fold_phase), where the checkout has it: each verifier's
     batch, small_proof and recursive_proof_16_15 at B=1024, np_small at
     B=512, level 14 and bitcoin at B=128, beside the plain version's time.
  The transcript kernel (transcript), where the checkout has it: at
     verify_batch's B=1024 on both fixtures, verify_batch_np's
     B=512, and small_proof at B=1 (the chain's) and 512, beside the plain
     version's time, the bound and, where the checkout has one, the
     latency floor (a proof's chain in dependent steps at the latency
     probe's cycles, ops/latency_cuda.py, measured here).
  The circle FFT (circle_fft, eval_tiles), where the checkout has it:
     every interpolation and LDE of chain levels 1 and 2 at their shapes
     (tools/prover_cases.fft_cases), and the tile evaluation of a streamed
     chunk of each first-layer group of level 14 and the last layer.
  The quotient kernel (quotients), where the checkout has it: every
     first-layer group of levels 1 and 2 over its domain, and a streamed
     chunk of each group of level 14 and the last layer.
  The sampling kernel (sample), where the checkout has it: every block and
     point a proof samples, in one launch, at the shapes of chain levels 1
     and 2 and of the last layer.
  The interaction kernel (interaction), where the checkout has it: each AIR
     table of chain levels 1 and 2 and the last layer's without-Poseidon
     table, one launch a table.
  The FRI fold-layer kernel (fri_fold), where the checkout has it: every
     fold launch of a level-1, a level-2 and a last-layer proof (the first
     layer's circle fold, each layer's line fold with its join), and the
     three summed a proof.
  The FRI last-layer kernel (fri_last), where the checkout has it: the
     last layer of chain_level12's PcsConfig ((4, 2**16), bound 7), of the
     bitcoin-facing proof ((4, 2**9), bound 0), of FRI(8, 5, 16) ((4,
     2**13), bound 8) and at 2**20 and 2**23 points.
  The Merkle level kernel (merkle_level), where the checkout has it: level
     2's four trees' leaf levels, tree 1's node level with its 48 merged
     columns, a node level without columns, the first FRI layer's leaf level
     (4 columns of 2**23), and a streamed chunk (the first 2**20 rows of
     tree 1's leaf level, the columns a view).
  All beside the plain version's time on the card and their bounds, on
  seeded random columns (tools/prover_cases.py).
`--kernels poseidon`, `--kernels composition`, `--kernels fold`,
`--kernels transcript`, `--kernels fft`, `--kernels quotients`,
`--kernels sample`, `--kernels interaction`, `--kernels fri_fold`,
`--kernels fri_last` or `--kernels merkle` times only those.
Before timing, every kernel output is held to the plain version bit for bit.
Prints ptxas' report of the transcript, check, domain, fold, FFT pass,
quotient, sampling, interaction, fold-layer, last-layer and Merkle level
kernels first.
Two times per shape: CUDA events around `reps` back-to-back calls (what a
caller's loop pays, the wrapper's host cost included once it exceeds the
kernel) and the kernels' mean device duration under torch.profiler.  Prints
one JSON line per (kernel, schedule, shape), then the card's nvidia-smi line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

P = 2**31 - 1
SEED = 2026
# (rows, reps): a transcript step, the sizes of the prover's Merkle levels
ROW_SHAPES = ((1024, 200), (1 << 12, 200), (1 << 14, 100), (1 << 15, 100), (1 << 16, 50),
              (1 << 17, 50), (1 << 18, 20), (1 << 20, 20), (1 << 23, 5))
WORDMAJOR_SHAPES = (((4, 16, 16384), 100), ((4, 16, 1 << 18), 20))
FIXTURES = ("small_proof", "recursive_proof_16_15")
SCAN_BATCH, SWEEP_BATCH, SWEEP_LOG_N = 1024, 1 << 14, range(12, 19)
# the check kernel's shapes (fixture, batch): verify_batch's, verify_batch_np's
# and the SHA fast paths'; the domain kernel at these chain levels' tables
CHECK_SHAPES = (("small_proof", 1024), ("recursive_proof_16_15", 1024), ("np_small", 1024), ("np_small", 512),
                ("level14", 1), ("bitcoin", 1))
DOMAIN_LEVELS = (1, 2)
NP_DOMAIN_LOG = 21  # the without-Poseidon AIR's table of random rows, as many points as the levels' domains
# the fold kernel at each verifier's batch: verify_batch's, verify_batch_np's
# and the SHA-256 device checks'
FOLD_SHAPES = (("small_proof", 1024), ("recursive_proof_16_15", 1024), ("np_small", 512), ("level14", 128),
               ("bitcoin", 128))
# the transcript kernel at verify_batch's and verify_batch_np's batches, the
# chain's batch 1 and a half batch
TRANSCRIPT_SHAPES = (("small_proof", 1024), ("recursive_proof_16_15", 1024), ("np_small", 512), ("small_proof", 1),
                     ("small_proof", 512))


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds per call of `reps` back-to-back calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiled_ms(torch, fn, reps: int, name: str, kernels_per_call: int = 1) -> float:
    """Mean device duration in milliseconds of the kernels whose name holds
    `name`, over `reps` calls under torch.profiler, times `kernels_per_call`
    (a call that launches several, as a transform's passes: the mean over
    the kernels the trace kept, so a call it lost counts for nothing).  A
    trace without such a kernel is taken again, up to three times: CUPTI now
    and then returns a trace with no device events, or with some missing."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total, count = 0.0, 0
        for evt in prof.key_averages():
            if name in evt.key:
                total += getattr(evt, "device_time_total", getattr(evt, "cuda_time_total", 0.0))
                count += evt.count
        if count:
            return total / count * kernels_per_call / 1e3
    raise RuntimeError(f"the profiler saw no kernel named *{name}* in three traces")


def _sub(prog, n: int):
    """The same pass over its first n slots."""
    from recursive_stwo_tpu_torch.verifier.hashplan import ScanProgram

    return ScanProgram(prog.ops, prog.sources, n, prog.n_out, prog.keep_capacity, prog.device)


def scan_runs(torch, poseidon_cuda, dev) -> list:
    """(kernel, schedule, shape, permutations, reps, fn) of the scan at the
    fixtures' passes and the N sweep, and of K2 at the leaf step, each held
    bit for bit to scan_plain (or K2's plain version) first."""
    from recursive_stwo_tpu_torch.core import poseidon2
    from recursive_stwo_tpu_torch.tools import scan_cases
    from recursive_stwo_tpu_torch.verifier import hashplan

    def scan(p):
        return poseidon_cuda.wordmajor_scan(p.ops, p.sources, p.n_out, p.n, p.keep_capacity)

    runs = []

    def add(label, prog, reps):
        steps = int(((prog.ops[..., poseidon_cuda.F_FLAGS] & poseidon_cuda.ACTIVE) != 0).any(0).sum())
        shape = f"{label} N={prog.n} ({prog.ops.shape[0]} lanes x {steps} steps)"
        if not torch.equal(scan(prog), hashplan.scan_plain(prog)):
            raise RuntimeError(f"wordmajor_scan differs from scan_plain at {shape}")
        runs.append(("wordmajor_scan", "scan", shape, poseidon_cuda.scan_permutations(prog.ops, prog.n),
                     reps, lambda: scan(prog)))

    leaf_state = None
    for name in FIXTURES:
        progs, leaves = scan_cases.fixture_programs(name, SCAN_BATCH, dev)
        leaf_state = leaf_state if leaf_state is not None else leaves
        for label, prog in progs:
            add(f"{name} {label}", prog, 20)
    progs, _ = scan_cases.fixture_programs("small_proof", SWEEP_BATCH, dev)
    for log_n in SWEEP_LOG_N:
        for label, prog in progs:
            add(f"small_proof {label} (sweep)", _sub(prog, 1 << log_n), 10)

    # K2 at the leaf step of small_proof at B=1024
    W, _, n = leaf_state.shape
    if not torch.equal(poseidon_cuda.permute_wordmajor(leaf_state), poseidon2.permute_wordmajor_plain(leaf_state)):
        raise RuntimeError("permute_wordmajor differs from the plain version at the leaf step")
    runs.append(("permute_wordmajor", "leaf step", tuple(leaf_state.shape), W * n, 50,
                 lambda: poseidon_cuda.permute_wordmajor(leaf_state)))
    return runs


def poseidon_runs(torch, poseidon2, poseidon_cuda, dev) -> list:
    """(kernel, schedule, shape, permutations, reps, fn) of K1, K2 and the
    scan, each held to its plain version first."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    if hasattr(poseidon_cuda, "permute_rows_schedule"):
        schedules = {s: (lambda x, s=s: poseidon_cuda.permute_rows_schedule(x, s)) for s in poseidon_cuda.ROWS_SCHEDULES}
        schedules["auto"] = poseidon_cuda.permute_rows
    else:
        schedules = {"rows": poseidon_cuda.permute_rows}
    runs = []
    for n, reps in ROW_SHAPES:
        x = torch.randint(0, P, (n, 16), generator=gen, device=dev, dtype=torch.int64)
        plain = poseidon2.permute_plain(x)
        for sched, fn in schedules.items():
            if not torch.equal(fn(x), plain):
                raise RuntimeError(f"permute_rows ({sched}) differs from the plain version at {(n, 16)}")
            runs.append(("permute_rows", sched, (n, 16), n, reps, lambda fn=fn, x=x: fn(x)))
        del plain
    for shape, reps in WORDMAJOR_SHAPES:
        x = torch.randint(0, P, shape, generator=gen, device=dev, dtype=torch.int64)
        if not torch.equal(poseidon_cuda.permute_wordmajor(x), poseidon2.permute_wordmajor_plain(x)):
            raise RuntimeError(f"permute_wordmajor differs from the plain version at {shape}")
        runs.append(("permute_wordmajor", "wordmajor", shape, shape[0] * shape[2], reps,
                     lambda x=x: poseidon_cuda.permute_wordmajor(x)))

    if hasattr(poseidon_cuda, "wordmajor_scan"):
        runs += scan_runs(torch, poseidon_cuda, dev)
    return runs


def composition_lines(torch, dev) -> list:
    """One dict a shape of the check kernel (CHECK_SHAPES) and the domain
    kernel (each table of DOMAIN_LEVELS), each held bit for bit to its plain
    version first: events and device ms, the plain version's ms, the bound."""
    from recursive_stwo_tpu_torch.models import flagship
    from recursive_stwo_tpu_torch.ops import composition_cuda
    from recursive_stwo_tpu_torch.tools import composition_cases as cases

    lat = _latencies(dev)
    lines = []
    for name, batch in CHECK_SHAPES:
        case = cases.check_case(name, batch, dev, corrupt_slot=batch // 2 if batch > 1 else None)
        (ok_k, v_k), (ok_p, v_p) = cases.check_value(case), cases.check_value(case, plain=True)
        if not (torch.equal(ok_k, ok_p) and all(torch.equal(a, b) for a, b in zip(v_k, v_p))):
            raise RuntimeError(f"composition_check differs from the plain version on {name} at B={batch}")
        bound, by = composition_cuda.check_bound_ms(case.spec, batch)
        lines.append(dict(kernel="composition_check", shape=f"{name} B={batch}", batch=batch,
                          int_ops=batch * composition_cuda.check_ops(case.spec),
                          events_ms=cuda_ms(torch, lambda: cases.check_value(case), 50),
                          device_ms=profiled_ms(torch, lambda: cases.check_value(case), 50, "composition_check"),
                          plain_ms=cuda_ms(torch, lambda: cases.check_value(case, plain=True), 3),
                          bound_ms=bound, bound_by=by))
        if lat:
            lines[-1].update(floor_ms=composition_cuda.latency_floor_ms(case.spec, lat))
    tables = [(f"level {level}", *_level_calls(flagship, cases, level, dev)) for level in DOMAIN_LEVELS]
    tables.append(("random rows", *_np_domain_calls(torch, cases, dev)))
    for label, calls, lookup, rc in tables:
        n = calls[0].perm.shape[0]
        acc = torch.zeros((4, n), dtype=torch.int64, device=dev)
        for call in calls:
            air = composition_cuda.air_id(call.evaluate_fn)
            plain = cases.run_domain(call, acc, lookup, rc, plain=True)
            if not torch.equal(cases.run_domain(call, acc.clone(), lookup, rc), plain):
                raise RuntimeError(f"composition_domain differs from the plain version on {label}, AIR {air}")
            bound, by = composition_cuda.domain_bound_ms(call.evaluate_fn, n, call.first)
            work = acc.clone()
            lines.append(dict(kernel="composition_domain", shape=f"{label} AIR {air} ({call.pre.shape[0]} + "
                              f"{call.tr.shape[0]} + {call.inter.shape[0]} rows x {n}"
                              f"{'' if call.first else ', accumulating'})", points=n,
                              int_ops=n * composition_cuda.domain_ops(air, call.first),
                              events_ms=cuda_ms(torch, lambda: cases.run_domain(call, work, lookup, rc), 10),
                              device_ms=profiled_ms(torch, lambda: cases.run_domain(call, work, lookup, rc), 10,
                                                    "composition_domain"),
                              plain_ms=cuda_ms(torch, lambda: cases.run_domain(call, acc, lookup, rc, plain=True), 1),
                              bound_ms=bound, bound_by=by))
            acc = plain
            del work
        del calls, acc
        torch.cuda.empty_cache()
    return lines


def _level_calls(flagship, cases, level: int, dev) -> tuple:
    """(domain calls, lookup, random_coeff) of chain level `level`'s tables."""
    trace, config, _ = flagship.chain_level_trace(level)
    spec, tables, lookup, rc = cases.prover_tables(trace, config, dev)
    return cases.domain_calls(spec, tables), lookup, rc


def _np_domain_calls(torch, cases, dev) -> tuple:
    """The without-Poseidon AIR on random canonical rows at 2**NP_DOMAIN_LOG
    points, as the first table and accumulating: (calls, lookup, rc)."""
    from recursive_stwo_tpu_torch.core.qm31 import QM31
    from recursive_stwo_tpu_torch.ops import composition_cuda
    from recursive_stwo_tpu_torch.verifier import composition as vcomp

    n = 1 << NP_DOMAIN_LOG
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n_pre, n_tr, n_fracs, batch = composition_cuda.AIR_SHAPES[composition_cuda.PLONK_NP]

    def rows(k):
        return torch.randint(0, P, (k, n), generator=gen, device=dev, dtype=torch.int64)

    def qm31():
        return QM31(*(int(x) for x in rows(4)[:, 0]))

    perm = torch.randperm(n, generator=gen, device=dev)
    call = cases.DomainCall(vcomp.evaluate_plonk_np, rows(n_pre), rows(n_tr), rows(4 * -(-n_fracs // batch)), perm,
                            rows(1)[0], True, qm31(), NP_DOMAIN_LOG - 1)
    return [call, call._replace(first=False)], (qm31(), qm31()), qm31()


def fold_lines(torch, dev) -> list:
    """One dict a shape of FOLD_SHAPES, the kernel held bit for bit to its
    plain version first (with tools/fold_cases.CORRUPTIONS): events and
    device ms, the plain version's ms, the bound."""
    from recursive_stwo_tpu_torch.ops import fold_cuda
    from recursive_stwo_tpu_torch.tools import fold_cases as cases

    lines = []
    for name, batch in FOLD_SHAPES:
        bad = cases.fold_case(name, batch, dev, corrupt=True)
        if not all(torch.equal(a, b) for a, b in zip(cases.fold_values(bad), cases.fold_values(bad, plain=True))):
            raise RuntimeError(f"fold_phase differs from the plain version on {name} at B={batch}")
        case = cases.fold_case(name, batch, dev)
        bound, by = fold_cuda.fold_bound_ms(case.spec, case.fs.raw_queries)
        ops = fold_cuda.fold_ops(case.spec)
        lines.append(dict(kernel="fold_phase", shape=f"{name} B={batch}", batch=batch,
                          int_ops_per_proof=ops.per_proof, int_ops_per_slot=ops.per_slot,
                          bytes=fold_cuda.fold_bytes(case.spec, *case.fs.raw_queries.shape),
                          events_ms=cuda_ms(torch, lambda: cases.fold_values(case), 50),
                          device_ms=profiled_ms(torch, lambda: cases.fold_values(case), 50, "fold_kernel"),
                          plain_ms=cuda_ms(torch, lambda: cases.fold_values(case, plain=True), 3),
                          bound_ms=bound, bound_by=by))
    return lines


def transcript_lines(torch, dev) -> list:
    """One dict a shape of TRANSCRIPT_SHAPES, the kernel held
    bit for bit to its plain version first (with tools/transcript_cases'
    corruptions): events and device ms, the plain version's ms, the bound
    and, where the checkout has the latency probe, the latency floor."""
    from recursive_stwo_tpu_torch.ops import transcript_cuda
    from recursive_stwo_tpu_torch.tools import transcript_cases as cases

    lat = _latencies(dev)
    lines = []
    for name, batch in TRANSCRIPT_SHAPES:
        bad = cases.transcript_case(name, batch, dev, corrupt=True)
        want = cases.replay_fields(bad, plain=True)
        case = cases.transcript_case(name, batch, dev)
        got = cases.replay_fields(bad)
        if not all(torch.equal(got[k], w) for k, w in want.items()):
            raise RuntimeError(f"transcript differs from the plain version on {name} at B={batch}")
        bound, by = transcript_cuda.transcript_bound_ms(case.spec, batch, len(case.inputs))

        def run():
            return transcript_cuda.transcript(case.spec, case.pa, case.inputs)

        lines.append(dict(kernel="transcript", shape=f"{name} B={batch}", batch=batch,
                          permutations=batch * transcript_cuda.permutations(case.spec),
                          int_ops=batch * transcript_cuda.transcript_ops(case.spec, len(case.inputs)),
                          bytes=transcript_cuda.transcript_bytes(case.spec, batch, len(case.inputs)),
                          events_ms=cuda_ms(torch, run, 50), device_ms=profiled_ms(torch, run, 50, "transcript_kernel"),
                          plain_ms=cuda_ms(torch, lambda: cases.replay_fields(case, plain=True), 3),
                          bound_ms=bound, bound_by=by))
        if lat:
            lines[-1].update(chain_permutations=transcript_cuda.chain_steps(case.spec),
                             floor_ms=transcript_cuda.latency_floor_ms(case.spec, lat))
    return lines


def fft_lines(torch, dev) -> list:
    """One dict a transform of chain levels 1 and 2 and a tile evaluation of
    a streamed chunk of level 14's and the last layer's groups, each held
    bit for bit to its plain version first: events and device ms (a
    transform's passes summed), the plain version's ms, the bound."""
    from recursive_stwo_tpu_torch.ops import fft_cuda
    from recursive_stwo_tpu_torch.tools import prover_cases as cases

    lines = []

    def add(kernel, label, run, plain, rows, b, segments, source_len, interpolate=False, tiles=False):
        if not torch.equal(run(), plain()):
            raise RuntimeError(f"{kernel} differs from the plain version on {label}")
        bound, by = fft_cuda.bound_ms(rows, b, segments, source_len, interpolate, tiles)
        # a call's kernels: its passes, and a tile evaluation's twiddle kernel
        # where the checkout has one
        per_call = (fft_cuda.kernels_per_call(b, tiles) if hasattr(fft_cuda, "kernels_per_call")
                    else fft_cuda.passes(b))
        lines.append(dict(kernel=kernel, shape=label, rows=rows, b=b, segments=segments, kernels_per_call=per_call,
                          bytes=fft_cuda.transform_bytes(rows, b, segments, source_len, tiles),
                          int_ops=fft_cuda.transform_ops(rows, b, segments, interpolate, tiles),
                          events_ms=cuda_ms(torch, run, 10),
                          device_ms=profiled_ms(torch, run, 10, "fft_", per_call),
                          plain_ms=cuda_ms(torch, plain, 1), bound_ms=bound, bound_by=by))

    for name in ("level1-5", "level2-1"):
        for case in cases.fft_cases(cases.prover_spec(name), dev, SEED):
            rows, n = case.x.shape
            b = n.bit_length() - 1
            add("circle_fft", f"{name} {case.label}", lambda: cases.run_fft(case),
                lambda: cases.run_fft(case, plain=True), rows, b, 1 << ((case.log_out or b) - b), n,
                interpolate=case.log_out is None)
    for name in ("level14-1", "bitcoin_proof"):
        spec = cases.prover_spec(name)
        for g in range(len(spec.all_log_sizes)):
            case = cases.tile_case(spec, g, dev, SEED)
            b = case.tiles.b
            add("eval_tiles", f"{name} {case.label}", lambda: cases.run_tiles(case),
                lambda: cases.run_tiles(case, plain=True), sum(c.shape[0] for c in case.blocks), b,
                case.tiles.bx.shape[0], 1 << b, tiles=True)
    return lines


def quotient_lines(torch, dev) -> list:
    """One dict a first-layer group of levels 1 and 2 (over its domain) and
    of level 14 and the last layer (a streamed chunk), each held bit for bit
    to its plain version first: events and device ms (both kernels of a
    call summed), the plain version's ms, the bound."""
    from recursive_stwo_tpu_torch.ops import quotients_cuda
    from recursive_stwo_tpu_torch.tools import prover_cases as cases

    lines = []
    for name, chunk_log in (("level1-5", None), ("level2-1", None), ("level14-1", cases.STREAM_CHUNK_LOG),
                            ("bitcoin_proof", cases.STREAM_CHUNK_LOG)):
        spec = cases.prover_spec(name)
        for g in range(len(spec.all_log_sizes)):
            case = cases.quotient_case(spec, g, dev, SEED + g, chunk_log)
            if not torch.equal(cases.run_quotients(case), cases.run_quotients(case, plain=True)):
                raise RuntimeError(f"quotients differ from the plain version on {name}'s {case.label}")
            n = case.blocks[0].shape[1]
            tile_log = None if chunk_log is None else case.points.b
            bound, by = quotients_cuda.bound_ms(spec, g, n, tile_log)
            lines.append(dict(kernel="quotients", shape=f"{name} {case.label}", points=n,
                              sampled_columns=len(quotients_cuda.group_tables(spec, g).entries),
                              bytes=quotients_cuda.quotient_bytes(spec, g, n, tile_log),
                              int_ops=n * quotients_cuda.point_ops(spec, g),
                              events_ms=cuda_ms(torch, lambda: cases.run_quotients(case), 10),
                              device_ms=profiled_ms(torch, lambda: cases.run_quotients(case), 10, "quotient_",
                                                    quotients_cuda.KERNELS_PER_CALL),
                              plain_ms=cuda_ms(torch, lambda: cases.run_quotients(case, plain=True), 1),
                              bound_ms=bound, bound_by=by))
            del case
    return lines


# the shapes of these committed chain proofs (levels 1 and 2 sample and
# generate the same shapes; the last layer is the without-Poseidon AIR)
PROVER_LEVELS = ("level1-5", "level2-1", "bitcoin_proof")


def sample_lines(torch, dev) -> list:
    """One dict a proof's OODS samples (every block and point in one
    launch) at PROVER_LEVELS' shapes, held bit for bit to the plain version
    first: events and device ms (both kernels of a call summed), the plain
    version's ms, the bound."""
    from recursive_stwo_tpu_torch.ops import sample_cuda
    from recursive_stwo_tpu_torch.tools import prover_cases as cases

    lines = []
    for name in PROVER_LEVELS:
        case = cases.sample_case(cases.prover_spec(name), dev, SEED)
        if not torch.equal(cases.run_sample(case), cases.run_sample(case, plain=True)):
            raise RuntimeError(f"sample differs from the plain version on {name}")
        shapes = sample_cuda.job_shapes(case.jobs)
        bound, by = sample_cuda.bound_ms(shapes)
        lines.append(dict(kernel="sample", shape=f"{name} {case.label}", jobs=shapes,
                          bytes=sample_cuda.sample_bytes(shapes), int_ops=sample_cuda.sample_ops(shapes),
                          events_ms=cuda_ms(torch, lambda: cases.run_sample(case), 20),
                          device_ms=profiled_ms(torch, lambda: cases.run_sample(case), 20, "sample_",
                                                sample_cuda.KERNELS_PER_CALL),
                          plain_ms=cuda_ms(torch, lambda: cases.run_sample(case, plain=True), 1),
                          bound_ms=bound, bound_by=by))
        del case
    return lines


def interaction_lines(torch, dev) -> list:
    """One dict an AIR table of PROVER_LEVELS, held bit for bit to the plain
    version first: events and device ms, the plain version's ms, the bound."""
    from recursive_stwo_tpu_torch.ops import composition_cuda, interaction_cuda
    from recursive_stwo_tpu_torch.tools import prover_cases as cases

    lines = []
    for name in PROVER_LEVELS:
        for case in cases.interaction_cases(cases.prover_spec(name), dev, SEED):
            if not torch.equal(cases.run_interaction(case), cases.run_interaction(case, plain=True)):
                raise RuntimeError(f"interaction differs from the plain version on {name}'s {case.label}")
            air = composition_cuda.air_id(case.evaluate_fn)
            n = case.pre.shape[1]
            bound, by = interaction_cuda.bound_ms(air, n)
            lines.append(dict(kernel="interaction", shape=f"{name} {case.label}", rows=n,
                              bytes=n * interaction_cuda.row_bytes(air), int_ops=n * interaction_cuda.row_ops(air),
                              events_ms=cuda_ms(torch, lambda: cases.run_interaction(case), 20),
                              device_ms=profiled_ms(torch, lambda: cases.run_interaction(case), 20,
                                                    "interaction_kernel"),
                              plain_ms=cuda_ms(torch, lambda: cases.run_interaction(case, plain=True), 1),
                              bound_ms=bound, bound_by=by))
    return lines


FOLD_LEVELS = ("level1-5", "level2-1", "bitcoin_proof")


def fri_fold_lines(torch, dev) -> list:
    """One dict a fold launch of FOLD_LEVELS' proofs (tools/prover_cases.
    fold_shapes), then one a proof with the launches summed, each launch held
    bit for bit to the plain version first: events and device ms, the plain
    version's ms, the bound."""
    from recursive_stwo_tpu_torch.ops import fri_fold_cuda
    from recursive_stwo_tpu_torch.tools import prover_cases as cases

    lines = []
    for name in FOLD_LEVELS:
        proof = []
        for k, (log, line, circle) in enumerate(cases.fold_shapes(cases.prover_spec(name))):
            case = cases.fold_case(log, line, circle, dev, SEED + k)
            if not torch.equal(cases.run_fold(case), cases.run_fold(case, plain=True)):
                raise RuntimeError(f"fri_fold differs from the plain version on {name}'s {case.label}")
            bound, by = fri_fold_cuda.bound_ms(log, line, circle)
            proof.append(dict(kernel="fri_fold", shape=f"{name} layer {k}: {case.label}", log_size=log,
                              bytes=fri_fold_cuda.layer_bytes(log, line, circle),
                              int_ops=fri_fold_cuda.layer_ops(log, line, circle),
                              events_ms=cuda_ms(torch, lambda: cases.run_fold(case), 20),
                              device_ms=profiled_ms(torch, lambda: cases.run_fold(case), 20, "fri_layer_kernel"),
                              plain_ms=cuda_ms(torch, lambda: cases.run_fold(case, plain=True), 1),
                              bound_ms=bound, bound_by=by))
            del case
            torch.cuda.empty_cache()
        lines += proof
        lines.append(dict(kernel="fri_fold", shape=f"{name}: a proof's {len(proof)} launches",
                          **{k: sum(r[k] for r in proof) for k in ("bytes", "int_ops", "events_ms", "device_ms",
                                                                    "plain_ms", "bound_ms")},
                          bound_by="bytes" if all(r["bound_by"] == "bytes" for r in proof) else "mixed"))
    return lines


# (level, bound): chain_level12's last layer, the bitcoin-facing proof's,
# FRI(8, 5, 16)'s, and two larger layers
LAST_SHAPES = ((16, 7), (9, 0), (13, 8), (20, 7), (23, 7))


def fri_last_lines(torch, dev) -> list:
    """One dict a last layer of LAST_SHAPES, held bit for bit to the plain
    version first: events and device ms, the plain version's ms, the bound;
    none where the checkout has no last-layer kernel."""
    from recursive_stwo_tpu_torch.ops import fri_fold_cuda
    from recursive_stwo_tpu_torch.tools import prover_cases as cases

    if not hasattr(fri_fold_cuda, "last_layer"):
        return []
    lines = []
    for level, bound in LAST_SHAPES:
        case = cases.last_layer_case(level, bound, dev, SEED + level)
        got = cases.run_last(case).cpu().numpy()
        want = cases.run_last(case, plain=True)
        if not (got[: 4 << bound] == want.reshape(-1)).all() or got[4 << bound :].any():
            raise RuntimeError(f"fri_last differs from the plain version on {case.label}")
        bound_ms, by = fri_fold_cuda.last_bound_ms(level, bound)
        lines.append(dict(kernel="fri_last", shape=case.label, log_size=level,
                          bytes=fri_fold_cuda.last_bytes(level, bound), int_ops=fri_fold_cuda.last_ops(level),
                          events_ms=cuda_ms(torch, lambda: cases.run_last(case), 50),
                          device_ms=profiled_ms(torch, lambda: cases.run_last(case), 50, "fri_last_kernel"),
                          plain_ms=cuda_ms(torch, lambda: cases.run_last(case, plain=True), 1),
                          bound_ms=bound_ms, bound_by=by))
        del case
        torch.cuda.empty_cache()
    return lines


def merkle_lines(torch, dev) -> list:
    """One dict a Merkle level (see the module docstring), each held bit for
    bit to the plain version first (the 2**23 leaf level in blocks of 2**21
    rows): events and device ms, the plain version's ms, the bound."""
    from recursive_stwo_tpu_torch.ops import merkle_cuda
    from recursive_stwo_tpu_torch.tools import prover_cases as cases

    spec = cases.prover_spec("level2-1")
    tree1 = spec.n_columns_per_log_size[1]
    todo = [cases.merkle_tree_case(spec, t, dev, SEED + t) for t in range(4)]
    todo += [cases.merkle_case(tree1[min(tree1)], min(tree1), dev, SEED, node=True),
             cases.merkle_case(0, 20, dev, SEED, node=True),
             cases.merkle_case(4, 23, dev, SEED),
             cases.merkle_tree_case(spec, 1, dev, SEED, rows=1 << 20)]
    lines = []
    for case in todo:
        if not torch.equal(cases.run_merkle(case), cases.run_merkle(case, plain=True, block=1 << 21)):
            raise RuntimeError(f"merkle_level differs from the plain version on {case.label}")
        n_cols, node = int(case.cols.shape[0]), case.children is not None
        bound, by = merkle_cuda.bound_ms(n_cols, node, case.n)
        lines.append(dict(kernel="merkle_level", shape=f"level 2 {case.label}", nodes=case.n,
                          permutations=case.n * merkle_cuda.permutations(n_cols, node),
                          bytes=merkle_cuda.level_bytes(n_cols, node, case.n),
                          events_ms=cuda_ms(torch, lambda: cases.run_merkle(case), 10),
                          device_ms=profiled_ms(torch, lambda: cases.run_merkle(case), 10, "merkle_level_kernel"),
                          plain_ms=cuda_ms(torch, lambda: cases.run_merkle(case, plain=True), 1),
                          bound_ms=bound, bound_by=by))
        torch.cuda.empty_cache()
    return lines


def _latencies(dev):
    """The latency probe's cycles a dependent step (and the clock), where
    the checkout has the probe; else None."""
    try:
        from recursive_stwo_tpu_torch.ops import latency_cuda
    except ImportError:
        return None
    lat = latency_cuda.step_latencies(dev)
    print(json.dumps(dict(kernel="latency_probe", cycles_a_step=lat)), flush=True)
    return lat


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--label", default=None, help="name printed with every line (default: the root)")
    ap.add_argument("--kernels", choices=("all", "poseidon", "composition", "fold", "transcript", "fft", "quotients",
                                          "sample", "interaction", "fri_fold", "fri_last", "merkle"),
                    default="all")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        print("kernel_times: torch.cuda.is_available() is false; this needs a GPU", file=sys.stderr)
        return 1
    from recursive_stwo_tpu_torch.core import poseidon2
    from recursive_stwo_tpu_torch.ops import build, poseidon_cuda

    label = args.label or args.root
    lib = build.load()
    log = build.library_path() + ".log"
    if os.path.exists(log):
        with open(log) as f:
            print(f"[{label}] ptxas:\n{f.read().strip()}")
    print(f"[{label}] library {os.path.basename(build.library_path())} from {lib._name}")
    if hasattr(build, "ptxas_report"):
        for name in ("transcript_kernel", "composition_check_kernel", "composition_domain_kernel", "fold_kernel",
                     "fft_pass_kernel", "fft_tile_twiddle_kernel", "quotient_coeffs_kernel", "quotient_points_kernel",
                     "sample_kernel", "sample_finish_kernel", "interaction_kernel", "fri_layer_kernel",
                     "fri_last_kernel", "merkle_level_kernel"):
            for r in build.ptxas_report(name):
                print(json.dumps(dict(label=label, ptxas=name, **r)), flush=True)
    if hasattr(build, "sass_instructions"):
        for name in ("composition_domain_kernel", "interaction_kernel", "sample_kernel"):
            for r in build.sass_instructions(name):
                print(json.dumps(dict(label=label, sass=name, **r)), flush=True)

    dev = torch.device("cuda")

    def has(wrapper):
        return os.path.exists(os.path.join(os.path.dirname(build.__file__), wrapper))

    for kind, wrapper, lines in (("composition", "composition_cuda.py", composition_lines),
                                 ("fold", "fold_cuda.py", fold_lines),
                                 ("transcript", "transcript_cuda.py", transcript_lines),
                                 ("fft", "fft_cuda.py", fft_lines),
                                 ("quotients", "quotients_cuda.py", quotient_lines),
                                 ("sample", "sample_cuda.py", sample_lines),
                                 ("interaction", "interaction_cuda.py", interaction_lines),
                                 ("fri_fold", "fri_fold_cuda.py", fri_fold_lines),
                                 ("fri_last", "fri_fold_cuda.py", fri_last_lines),
                                 ("merkle", "merkle_cuda.py", merkle_lines)):
        if args.kernels in ("all", kind) and has(wrapper):
            for line in lines(torch, dev):
                line.update(label=label, share_of_bound=line["bound_ms"] / line["device_ms"])
                print(json.dumps(line), flush=True)
    runs = poseidon_runs(torch, poseidon2, poseidon_cuda, dev) if args.kernels in ("all", "poseidon") else []
    for kernel, sched, shape, n_states, reps, fn in runs:
        ms = cuda_ms(torch, fn, reps)
        dev_ms = profiled_ms(torch, fn, reps, kernel)
        line = dict(label=label, kernel=kernel, schedule=sched,
                    shape=shape if isinstance(shape, str) else list(shape), events_ms=ms,
                    device_ms=dev_ms, permutations=n_states, mperm_per_s=n_states / dev_ms / 1e3)
        if hasattr(poseidon_cuda, "bound_ms"):
            bound, by = poseidon_cuda.bound_ms(n_states)
            line.update(bound_ms=bound, bound_by=by, share_of_bound=bound / dev_ms)
        print(json.dumps(line), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
