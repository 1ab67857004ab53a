#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (recursive_stwo_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases; any failure ends the run with a non-zero exit and no result line:
  1. card: the GPU's name and power limit, as nvidia-smi prints them;
  2. build: nvcc builds the Poseidon2-16, Poseidon31 grind, SHA-256,
     SHA-256 grind, composition, fold, transcript, circle FFT, quotient, sampling,
     interaction, FRI fold-layer, FRI last-layer and Merkle level kernels and
     the latency probe from csrc/ (one nvcc a source, all at once, then a
     link; seconds); ptxas' report (registers, stack frame, spills) of the
     transcript, check, domain, fold, FFT pass, quotient, sampling,
     interaction, fold-layer, last-layer, Merkle level and both grind
     kernels on lines of their own;
  3. kernels vs plain: K1 and K2 against their plain PyTorch versions on
     the card and on the host CPU, bit for bit, at 2**20 states and at the
     main path's shapes, plus the Poseidon2-16 known-answer test; each of
     K1's schedules at 1, 7, 8, 1023, 1024, 2**20 + 3 and 2**23 rows; the
     hash phase's scan kernel against scan_plain on the card, bit for bit,
     on seeded programs holding every op kind at N = 1, 7, 127, 129, 16384
     slots and 1-4 lanes, and on both fixtures' absorb and walk passes at
     B=1024; the same for phase 10's shapes: K1 at (512, 16), K2 at
     np_small's leaf step and the scan on np_small's passes at B=512;
     kernel times (device time under torch.profiler, and back to back under
     CUDA events), plain-version times, and each time beside its bound; the
     SHA-256 tree-level kernel against its plain version on the card, bit
     for bit: leaf levels of 1, 8, 13, 14, 16, 40 and 12 columns (the last
     layer's widest tree), node levels with and without columns, at 1, 7,
     127, 129 and 2**20 + 3 rows, and a column slice; against the native
     host SHA-256 at 2**20 leaves; its times at a 2**20-row leaf chunk, a
     2**20-node level and a 2**27-row leaf level; the composition check
     kernel against its plain version on the card, on the value and on the
     bool, bit for bit: every verifier's fixture (small_proof,
     recursive_proof_16_15, np_small, level 14, bitcoin) at B = 1, 3, 7, 33,
     1023 and 1024 (four proofs a block) with a sampled value corrupted in
     one slot, and random canonical inputs of each spec; the domain kernel against its plain version table
     by table on the demo circuits (both AIR pairs) and chain level 1, each
     table also accumulating into a random accumulator; their
     times (the check at small_proof's B=1024, np_small's B=512 and level
     14's B=1; the domain kernel on level 1's tables) beside their bounds
     and the check's latency floor;
     the fold kernel (csrc/fold.cu) against its plain version on the card,
     bit for bit (every group's answers, every inner layer's self values,
     the last-layer check): small_proof and recursive_proof_16_15 at B = 1,
     3, 7, 33, 1023 and 1024 (a block a proof), np_small at B=512, level 14
     and bitcoin at B=128, each with
     four corrupted slots (a sampled value, a first-layer sibling, an
     inner-layer sibling, an OODS point whose quotient denominators are
     zero) and on random canonical inputs of its shapes; its times (both
     fixtures at B=1024, np_small at B=512, level 14 at B=128) beside its
     bound; the transcript kernel (csrc/transcript.cu) against its plain
     version on the card, bit for bit (every FSOutput field, the OODS point,
     the input sum, the PoW and total-sum checks): both fixtures at B = 1, 3,
     7, 33, 1023 and 1024 (sixteen proofs a block) with a
     flipped nonce limb and a flipped commitment word in two slots and with
     a wrong public input, np_small at B=512 with and without public inputs,
     and random canonical inputs of each spec (an input term zero in slot
     0); its times (both fixtures at B=1024, np_small at B=512, small_proof
     at B=1 and 512) beside its bound and its latency floor (a proof's
     chain in dependent steps, each at the latency the probe measures
     on the card, ops/latency_cuda.py); the provers' circle FFT
     (csrc/circle_fft.cu) against its plain versions, bit for bit:
     interpolate, evaluate and the LDE x2 and x8 at FFT_SHAPES, every
     interpolation and LDE of chain levels 1 and 2 at their shapes
     (tools/prover_cases.py, seeded random columns) and both ends of an LDE
     of 17 columns to 2**27 (past 2**31 elements); its tile entry at
     TILE_SHAPES, a tile of one coefficient and a streamed chunk of every
     first-layer group of level 2, level 14 and the last layer; the quotient
     kernel (csrc/quotients.cu) on every first-layer group of levels 1 and 2
     over its domain (and with the OODS point on the domain, its
     denominators zero) and on a streamed chunk of every group of level 14
     and the last layer; their times (the FFT at level 2's largest LDE and
     interpolation, the tiles at the last layer's chunk, the quotients at
     level 2's three groups) beside their bounds and the plain versions';
     the sampling kernel (csrc/sample.cu) against its plain version, bit
     for bit, on every block and point of a level-1, a level-2 and a
     last-layer proof's OODS samples (one launch each, seeded random
     coefficients at their shapes), on a constant polynomial, on a block of
     2**27 coefficients and on every coefficient and factor at p - 1; the
     interaction kernel (csrc/interaction.cu) against its plain version,
     bit for bit, on the plonk and poseidon tables of levels 1 and 2 and
     the last layer's without-Poseidon table, each plonk and
     without-Poseidon table also with a zero denominator planted (inv(0) =
     0); their times at level 1 (a proof's samples; both tables) beside
     their bounds and the plain versions'; the FRI fold-layer kernel
     (csrc/fri_fold.cu) against its plain version, bit for bit, at logs 1,
     2, 3 and 17 (a line fold, a join alone, both) and at every fold launch
     of a level-1, level-2, level-14 and last-layer proof (seeded random
     layers at their shapes, up to the last layer's circle fold of (4,
     2**27)); the FRI last-layer kernel (csrc/fri_fold.cu) against its
     plain version, bit for bit (the kept coefficients, every count 0), at
     LAST_SHAPES and at the last layer of every PROVER_SHAPES proof, and
     with three coefficients planted past the bound at each, which it must
     count in every column (and last_layer_poly refuse); the Merkle level
     kernel (csrc/merkle.cu) against its plain version, bit for bit, on
     leaf and node levels of 0, 1, 8, 9 and 134 columns at 1, 7 and
     2**20 + 3 nodes, a strided column view and a 2**27-leaf level of 4
     columns; their times at level 1 (a proof's fold launches; tree 1's
     leaf level, with level 2's and a streamed chunk's beside it; the last
     layer at chain_level12's (4, 2**16), bound 7) beside their bounds and
     the plain versions';
  4. main path, small_proof at B=1024: the port's verify_batch on CUDA over
     a batch with a flipped sibling hash and a flipped nonce, and again with
     a wrong public input; every named check of every slot must equal the
     port's own CPU path (plain PyTorch, which tests/test_torch_verify.py
     holds equal to the JAX package's verifier); the transcript kernel must
     have launched exactly once and K1 never, the scan exactly twice (the
     absorb and the walk pass), K2 exactly once (the leaf step), the
     composition check kernel exactly once and the fold kernel exactly once;
  5. the same for the deep fixture recursive_proof_16_15;
  6. timing: warm proofs/s of verify_batch at B=1024 for both fixtures, and
     the walls of the transcript, the fold phase, the hash phase and the
     composition check per batch (each bounded by synchronize()) beside it;
  7. prover, recursion-chain level 1: the demo circuit's proof on CUDA must
     equal the port's CPU proof byte for byte (a quick first check), its
     last layer one launch of the last-layer kernel; then
     the level-1 circuit (recursive_proof_16_15 verified five times) is
     built on the host and proved on CUDA with the port's `prove`
     (tools/chain.run_level); its m31x8 bytes must hash to level1-5.bin's
     digest in docs/chain_artifacts.txt (a51ea3f3...), the port's
     verify_batch on CUDA must accept it, the Merkle level kernel must have
     launched while proving and K1 never (the 20-bit PoW is one launch of
     the Poseidon31 grind kernel), the fold-layer kernel once a FRI layer and once for the first
     (spec.n_inner_layers + 1), the last-layer kernel once, the composition
     domain kernel once an AIR
     table (twice), the circle FFT, the quotient kernel once a first-layer
     group, the sampling kernel once and the interaction kernel once an
     AIR table; the
     proof runs under a device-only torch.profiler trace; prints the wall
     time (traced), each stage's time, the kernels' launches, the CUDA
     kernels of the trace (eager torch's and the hand-written ones) and the
     peak device memory;
  8. the same for level 2 (the committed level1-5.pkl verified once,
     fast_prover2, largest domain 2**23; level2-1.bin, 7476baa5...) and
     level 3 (the committed level2-1.pkl verified once, preset standard,
     2**23; level3-1.bin, 642d38ee...; the repo holds no level-3 proof);
  9. grinds: the Poseidon31 grind kernel (csrc/poseidon2_grind.cu, one
     launch a grind, the provers' path at every bits) at 24 and 28 bits on
     seeded digests must find grind_device's nonce (its plain version, K1
     on blocks of 2**22 states: K1's main path since the trees left it) and
     the host native scan's; prints the three times and the kernel's device
     time at 28 bits beside grind_bound_ms; the SHA-256 grind kernel
     (csrc/sha256_grind.cu, one launch a grind) must find the native scan's
     nonce on seeded digests at 16, 20, 24 and 28 bits, and one from just
     below 2**32; its time at the 28-bit grind (device, under
     torch.profiler, and the call's wall with its result read) beside
     grind_bound_ms of the nonces up to the hit, and the host scan's;
 10. without-Poseidon on the Poseidon31 channel, np_small at B=512 (bench.py's
     batch for np_flavor_proofs_per_sec): verify_batch_np on CUDA over a
     batch with a flipped sibling hash and a flipped nonce, and again with a
     wrong public input, every named check of every slot equal to the CPU
     run; the transcript kernel must launch once and K1 never, the scan
     exactly twice, K2 once, the check kernel once and the fold kernel once;
     then warm proofs/s (median of 5, synchronize()-bounded);
 11. the SHA-256 flavours, chain level 14 and the bitcoin-facing last-layer
     proof, with the native SHA-256 library required: both host verifiers
     and both fast paths (composition on CUDA) accept, and the fast paths
     reject a corrupted sampled value (level 14), a corrupted first-layer
     FRI witness and a wrong public input (bitcoin) by the named check; the
     device checks at B=128 on CUDA, with a flipped sampled value and a
     flipped pow digest in two slots, equal the CPU run per slot; each
     accepting fast path and each device-check call launches the check
     kernel exactly once, each device-check call the fold kernel once; prints bench.py's SHA metrics (the fast path's
     time with the composition on CUDA and on the CPU), the bitcoin fast
     path's times on both and the level-14 device checks' proofs/s;
 12. the last layer: the committed level-14 proof verified in the
     PlonkWithoutPoseidon circuit, proved on CUDA with prove_np in the
     Sha256MerkleChannel flavour at pow 28, FRI(0, 9, 8) (largest domain
     2**27; tools/chain.run_level); its "bytes32" bytes must hash to
     bitcoin_proof.bin's 71da12a3..., and verify_sha256np on CUDA must
     accept it; its 22 SHA-256 trees are hashed on the card by the SHA-256
     kernel (which must launch), its FRI layers by spec.n_inner_layers + 1
     fold-layer launches and one last-layer launch, its one AIR table by one launch of the
     domain kernel and one of the interaction kernel, its transforms by the
     circle FFT, its OODS samples by one launch of the sampling kernel, its
     two first-layer groups by two launches of the quotient kernel, under
     the trace;
     prints the wall, each stage, the eager and hand-written kernels, the peak
     device memory, the kernels' launches and the trees' hashing and digest
     copy-back time;
 13. prove_sha256p31 of the demo circuit on CUDA equals the CPU run, byte
     for byte ("bytes32"), its folds spec.n_inner_layers + 1 fold-layer
     launches, its last layer one last-layer launch and no Merkle level
     launch (SHA-256 trees);
 14. multi-device verification (recursive_stwo_tpu_torch/parallel): (a) the
     dry run on one NCCL rank on the card and, at the same time, (b) the
     dry run on MESH_RANKS gloo ranks sharing the card (the (2, 2) host x
     chip reduction and the fault attribution on CUDA verifiers); (c) phase 4's batch split over
     MESH_RANKS gloo ranks on the card with verify_sharded: every named
     check of every slot must equal phase 4's CPU run, and each rank's
     verify_batch must launch the transcript kernel once and K1 never, the
     scan twice, K2 once, the check kernel once and the fold kernel once;
     the dry runs' ranks the transcript kernel and never K1; (d) warm proofs/s of the
     clean B=1024 batch split over 1, 2 and MESH_RANKS ranks sharing the
     card (verify_local: the
     batch over the slowest rank's synchronize()-bounded wall, median of
     MESH_RUNS), each rank's kernels and copies and fills in one call, and
     the card's busy share (the ranks' kernel time under torch.profiler,
     summed, over that wall); information only;
 15. the streamed provers (prover/stream.py): (a) the demo circuit proved on
     CUDA and on the CPU at chunk_log 9, cutoff 5 by prove_streamed in both
     flavours and a small PlonkWithoutPoseidon circuit by prove_np_streamed
     in both tree flavours, the same bytes on both, each CUDA run's folds
     spec.n_inner_layers + 1 fold-layer launches and one last-layer
     launch, its Poseidon31 trees on
     the Merkle level kernel and K1 never; (b) chain level 3
     streamed at the defaults (chunks of 2**20 rows), its m31x8 bytes
     hashing to level3-1.bin's 642d38ee..., accepted by verify_batch on
     CUDA, the Merkle level kernel launched and K1 never; (c) the last layer streamed in the
     Sha256MerkleChannel flavour (largest domain 2**27), its "bytes32" bytes
     hashing to bitcoin_proof.bin's 71da12a3..., accepted by
     verify_sha256np on CUDA, the SHA-256 kernel launched; each streamed
     proof launches the domain kernel and the interaction kernel once an
     AIR table, the sampling kernel once, the fold-layer kernel
     spec.n_inner_layers + 1 times, the last-layer kernel once, the circle
     FFT, the tile kernel,
     and the quotient kernel once a streamed chunk of 2**20 points.  (b) and (c) run
     under a device-only torch.profiler trace, which counts every kernel
     the card ran; each prints its wall (traced), stages, the kernels'
     launches and the eager launches, and its peak device memory beside
     the resident proof's of the same level in this run (phase 8's level 3,
     phase 12's last layer); its own peak (above what the process held when
     the proof began: tables cached by earlier phases) must be below the
     resident proof's own peak.
Phases 7, 8, 12, 13 and 15 print each proof's wall, peak GiB and launches,
and every phase its seconds.  The last three lines are the nvidia-smi line,
a JSON line describing the kernels (prover_launches, level2_launches,
level3_launches and last_layer_launches: phase 7's level 1, phase 8's
levels 2 and 3 and phase 12's last layer; streamed_launches: phase 15's
(b) and (c); np_launches, np_shape, np_ms, np_plain_ms and np_bound_ms:
phase 10's launches and shapes, and the kernel's times there;
mesh_launches: each rank's launches in phase 14 (c); launches is each
kernel's count in its main path: phase 4's verify_batch, phase 9's
grind_device for K1, phase 15 (c) for the SHA-256 grind, phase 7's level 1 for the Poseidon31 grind, the domain
kernel, the circle FFT, the quotients, the sampling, the interaction, the fold-layer, the last-layer
and the Merkle level kernels, phase 15 (c)
for the SHA-256 and tile kernels; K1's
times are at 2**20 rows (grind_device hashes blocks of 2**22), with step_* at (1024,
16); floor_ms the latency floors of the transcript and check kernels),
and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

P = 2**31 - 1
BATCH = 1024
SEED = 2026
SIB_SLOT, NONCE_SLOT = 3, 5
KAT = [
    260776483, 1182896747, 1656699352, 746018898, 102875940, 1812541025,
    515874083, 755063943, 1682438524, 1265420601, 238640995, 200799880,
    1659717477, 2080202267, 1269806256, 1287849264,
]
FIXTURES = ("small_proof", "recursive_proof_16_15")
LAST_LAYER = 15  # the last layer's place in tools/chain.py's order
# sha256 of the .bin of each chain proof the smoke re-proves
# (docs/chain_artifacts.txt): m31x8 bytes for levels 1-3, "bytes32" for the
# last layer (bitcoin_proof.bin)
LEVEL_SHA256 = {
    1: "a51ea3f3d96636750c573b2d46846d9f9e47ecb955fc510c63cec1f0c76be49b",
    2: "7476baa51d927962fd8ab7b766409b39f5a2fc8009ff6c2bb2e04ca2078c73a3",
    3: "642d38eed1f77f4dd577d8de0232a70590c09abe7154f53600d6b33fdb8c7c3f",
    LAST_LAYER: "71da12a3fa9ebcef7cfabfeac33b08712affbda758f0d31a5e7aba164c8d39e3",
}
PROVER_LEAF_ROWS = 1 << 23  # K1 at 2**23 rows, above its largest call (2**22: grind_device's block)
# K1's schedules are each held to the plain version at these row counts:
# tails of a warp's 8 rows and a block's 32, and the prover's largest call
ROWS_CHECKED = (1, 7, 8, 1023, 1024, (1 << 20) + 3, PROVER_LEAF_ROWS)
GRIND_BITS = (24, 28)  # phase 9's Poseidon31 grinds (digest seed SEED + bits); the timed one last
SHA_GRIND_BITS = (16, 20, 24, 28)  # phase 9's SHA-256 grinds; the timed one last
NP_BATCH = 512  # bench.py:187-188
SHA_BATCH = 128  # bench.py:248
SAMPLE_SLOT = 7
SAMPLE_LEVELS = ("level1-5", "level2-1", "bitcoin_proof")  # the proofs whose OODS samples phase 3 holds
SAMPLE_BIG_LOG = 27  # the sampling kernel's largest block: one column of 2**27 coefficients
ZERO_ROW = 12345  # the row of a planted zero denominator in phase 3's interaction tables
# the scan kernel is held to scan_plain at these slots (tails of a warp and
# of a block of 128 threads) with 1-4 lanes
SCAN_SLOTS_CHECKED = (1, 7, 127, 129, 16384)
MESH_RANKS = 4  # phase 14: gloo ranks sharing the card
MESH_SIZES = (1, 2, MESH_RANKS)  # the rank counts timed in phase 14 (d)
MESH_RUNS = 5
MESH_TIMEOUT = 300.0  # seconds a spawn of phase 14 may take
# the SHA-256 kernel is held to its plain version on leaf levels of these
# column counts (one block up to 13 words, two from 14, three at 40; 12 is
# the last layer's widest tree, its trace columns) at these row counts
# (tails of a warp and of a block of 128 threads)
LAST_LAYER_WIDEST = 12
SHA_COLS_CHECKED = (1, 8, 13, 14, 16, 40, LAST_LAYER_WIDEST)
SHA_ROWS_CHECKED = (1, 7, 127, 129, (1 << 20) + 3)
SHA_CHUNK_ROWS = 1 << 20  # a streamed tree's leaf chunk (prover/stream.py CHUNK_LOG)
SHA_BIG_ROWS = 1 << 27  # the last layer's largest tree, the first FRI layer's (4 limb columns)
STREAM_DEMO = dict(chunk_log=9, cutoff=5)  # phase 15 (a): several chunks of several tiles
# the check kernel is held to its plain version at these batch sizes (one
# proof, tails of its blocks of four, the main path's batch); the domain kernel on the
# demo circuits' tables and chain level 1's
COMP_BATCHES = (1, 3, 7, 33, BATCH - 1, BATCH)
DOMAIN_LEVEL = 1
# the fold kernel is held to its plain version at these batch sizes of both
# fixtures, and at the other flavours' batches
FOLD_BATCHES = (1, 3, 7, 33, BATCH - 1, BATCH)
# the transcript kernel is held to its plain version at these batch sizes of
# both fixtures (the chain's batch 1, tails of its blocks of sixteen, the
# main path's batch)
TRANSCRIPT_BATCHES = (1, 3, 7, 33, BATCH - 1, BATCH)

# the circle FFT is held to its plain version at these (log, columns): one
# point, one butterfly, one radix-8 round, tails of a block's tile of 2**13,
# clusters of 2-8 blocks (2**14-2**18) and two passes (2**19-2**21); at LDEs
# of these (log, segments); the tile kernel at these (T, b, tiles [t0, t1),
# column blocks), level 14's tiles of 2**15 and the last layer's of 2**17 on
# clusters among them; both at the shapes of these committed chain proofs
# (tools/prover_cases.py)
FFT_SHAPES = ((0, 1), (1, 1), (3, 2), (5, 3), (11, 1), (12, 5), (13, 2), (15, 2), (16, 1), (17, 2), (18, 1),
              (19, 1), (20, 1), (21, 9))
LDE_SEGMENTS = ((12, 1), (12, 2), (12, 512), (17, 2), (18, 8))
TILE_SHAPES = ((6, 1, 0, 32, (3,)), (12, 9, 2, 6, (2, 1, 5)), (10, 4, 5, 61, (1,)), (16, 13, 3, 7, (4,)),
               (20, 15, 4, 12, (3, 5, 2)), (24, 17, 3, 8, (2, 3)))
PROVER_SHAPES = ("level1-5", "level2-1", "level14-1", "bitcoin_proof")
# the fold-layer kernel is held to its plain version at these logs (line,
# join and both each) and at every fold launch of PROVER_SHAPES' proofs
FOLD_LOGS = (1, 2, 3, 17)
# the last-layer kernel is held to its plain version at these (level, bound)
# (chain_level12's and level 14's last layer, FRI(8, 5, 16)'s, the
# bitcoin-facing proof's) and at the last layer of every PROVER_SHAPES proof,
# each also with three coefficients planted past the bound
LAST_SHAPES = ((16, 7), (13, 8), (9, 0))
# the Merkle level kernel at these (columns, nodes) of leaf and node levels
# (tails of a block of 128 threads and of a 2**20 chunk; 134 columns the
# chain's widest group), a strided view, and a 2**27-leaf level of 4 columns
# (the last layer's first FRI layer) checked in blocks of MERKLE_BLOCK rows
MERKLE_COLS = (0, 1, 8, 9, 134)
MERKLE_ROWS = (1, 7, (1 << 20) + 3)
MERKLE_BIG_LOG = 27
MERKLE_BLOCK = 1 << 22


class SmokeError(RuntimeError):
    pass


def require(cond, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def check_kernels(torch, dev, leaf_state, np_leaf_state) -> dict:
    """Phase 3, K1 and K2.  Returns per-kernel {max_abs_err, ms, events_ms,
    plain_ms, bound_ms, bound_by} at the main path's shapes (for K2 the leaf
    step's (W, 16, B*Q) states, `leaf_state`): ms is the kernel's mean
    device time under torch.profiler, events_ms the CUDA-event time of
    back-to-back calls (the wrapper's host cost included).  The same, under
    np_*, at phase 10's shapes: K1 at (NP_BATCH, 16), K2 at np_small's leaf
    step (`np_leaf_state`)."""
    from recursive_stwo_tpu_torch.core import poseidon2
    from recursive_stwo_tpu_torch.ops import poseidon_cuda
    from recursive_stwo_tpu_torch.tools.kernel_times import cuda_ms, profiled_ms

    n = 1 << 20
    x = np.random.default_rng(SEED).integers(0, P, (n, 16), dtype=np.int64)
    x[0], x[1], x[2] = np.arange(16), P - 1, 0
    t = time.perf_counter()
    host = poseidon2.permute_plain(torch.from_numpy(x)).numpy()
    print(f"host reference (plain version on the CPU) permuted {n} states "
          f"in {time.perf_counter() - t:.2f} s")
    xd = torch.from_numpy(x).to(dev)

    rows = {"kernel": poseidon_cuda.permute_rows, "plain": poseidon2.permute_plain}
    wm = {"kernel": poseidon_cuda.permute_wordmajor, "plain": poseidon2.permute_wordmajor_plain}
    # (kernel, plain) pairs on: 2**20 rows, (4, 16, 2**18) word-major, and the
    # main path's shapes, a transcript step (B, 16) and the leaf step (W, 16, B*Q)
    big_wm = xd.reshape(4, n // 4, 16).permute(0, 2, 1).contiguous()
    main_rows = xd[:BATCH].contiguous()
    np_rows = xd[BATCH:BATCH + NP_BATCH].contiguous()
    result = {}
    for name, fns, big, main, np_main, reps in (
        ("permute_rows", rows, xd, main_rows, np_rows, 200),
        ("permute_wordmajor", wm, big_wm, leaf_state, np_leaf_state, 100),
    ):
        err = 0
        for inp in (big, main, np_main):
            k, p = fns["kernel"](inp), fns["plain"](inp)
            torch.cuda.synchronize()
            require(torch.equal(k, p), f"{name} differs from its plain version at {tuple(inp.shape)}")
            err = max(err, int((k - p).abs().max()))
        k = fns["kernel"](big)
        k_rows = k if name == "permute_rows" else k.permute(0, 2, 1).reshape(n, 16)
        require(np.array_equal(k_rows.cpu().numpy(), host), f"{name} differs from the host reference")
        require(k_rows[0].tolist() == KAT, f"{name} fails the known-answer test")

        n_main = main.numel() // 16
        bound, bound_by = poseidon_cuda.bound_ms(n_main)
        big_bound, big_by = poseidon_cuda.bound_ms(n)
        big_ms = profiled_ms(torch, lambda: fns["kernel"](big), 20, name)
        big_plain = cuda_ms(torch, lambda: fns["plain"](big), 2)
        ms = profiled_ms(torch, lambda: fns["kernel"](main), reps, name)
        events_ms = cuda_ms(torch, lambda: fns["kernel"](main), reps)
        plain_ms = cuda_ms(torch, lambda: fns["plain"](main), 10)
        np_n = np_main.numel() // 16
        np_bound, _ = poseidon_cuda.bound_ms(np_n)
        np_ms = profiled_ms(torch, lambda: fns["kernel"](np_main), reps, name)
        np_plain = cuda_ms(torch, lambda: fns["plain"](np_main), 10)
        print(f"{name}: bit-exact vs plain and host at {tuple(big.shape)}, {tuple(main.shape)} "
              f"and {tuple(np_main.shape)}; KAT ok")
        print(f"{name} {tuple(big.shape)}: kernel {big_ms:.4f} ms device ({n / big_ms / 1e3:.4g} Mperm/s; "
              f"bound {big_bound:.4f} ms by {big_by}), plain {big_plain:.4f} ms")
        print(f"{name} {tuple(main.shape)}: kernel {ms:.4f} ms device, {events_ms:.4f} ms per call back to back "
              f"({n_main / ms / 1e3:.4g} Mperm/s; bound {bound:.6f} ms by {bound_by}), plain {plain_ms:.4f} ms")
        print(f"{name} {tuple(np_main.shape)} (np_small): kernel {np_ms:.4f} ms device "
              f"({np_n / np_ms / 1e3:.4g} Mperm/s; bound {np_bound:.6f} ms), plain {np_plain:.4f} ms")
        result[name] = dict(max_abs_err=err, ms=ms, events_ms=events_ms, plain_ms=plain_ms,
                            bound_ms=bound, bound_by=bound_by, library_ms=None,
                            np_shape=list(np_main.shape), np_ms=np_ms, np_plain_ms=np_plain,
                            np_bound_ms=np_bound)
        if name == "permute_rows":
            # K1's main path is the prover's Merkle commits (the verifier's
            # transcript has its own kernel): its line's times are at 2**20
            # rows, a block of a prover level; (BATCH, 16) is kept as one
            # permutation's latency on K1's quad schedule
            result[name].update(shape=list(big.shape), ms=big_ms, plain_ms=big_plain, bound_ms=big_bound,
                                bound_by=big_by, step_shape=list(main.shape), step_ms=ms,
                                step_events_ms=result[name].pop("events_ms"), step_plain_ms=plain_ms,
                                step_bound_ms=bound)

    # every K1 schedule bit for bit at tail sizes and at PROVER_LEAF_ROWS
    # rows, made on the card from a seed, and the KAT in row 0
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for rows_n in ROWS_CHECKED:
        s = torch.randint(0, P, (rows_n, 16), generator=gen, device=dev, dtype=torch.int64)
        s[-1] = P - 1
        s[0] = torch.arange(16, device=dev)
        plain = poseidon2.permute_plain(s)
        for sched in poseidon_cuda.ROWS_SCHEDULES:
            k = poseidon_cuda.permute_rows_schedule(s, sched)
            torch.cuda.synchronize()
            require(torch.equal(k, plain), f"permute_rows ({sched}) differs from its plain version at {rows_n} rows")
            require(k[0].tolist() == KAT, f"permute_rows ({sched}) fails the known-answer test at {rows_n} rows")
        del plain
    print(f"permute_rows: schedules {poseidon_cuda.ROWS_SCHEDULES} bit-exact vs plain at {ROWS_CHECKED} rows; KAT ok")
    leaf_ms = profiled_ms(torch, lambda: poseidon_cuda.permute_rows(s), 10, "permute_rows")
    leaf_plain = cuda_ms(torch, lambda: poseidon2.permute_plain(s), 1)
    leaf_bound, _ = poseidon_cuda.bound_ms(PROVER_LEAF_ROWS)
    print(f"permute_rows {tuple(s.shape)} (prover leaves): kernel {leaf_ms:.4f} ms device "
          f"({PROVER_LEAF_ROWS / leaf_ms / 1e3:.4g} Mperm/s; bound {leaf_bound:.4f} ms), plain {leaf_plain:.4f} ms")
    result["permute_rows"].update(prover_shape_ms=leaf_ms, prover_shape_plain_ms=leaf_plain,
                                  prover_shape_bound_ms=leaf_bound)
    return result


def check_scan(torch, dev, programs: dict) -> dict:
    """Phase 3, the scan kernel against scan_plain on the card, bit for bit:
    seeded programs at SCAN_SLOTS_CHECKED slots and 1-4 lanes, and each
    fixture's absorb and walk passes (`programs`, name -> [(label,
    ScanProgram)]: both PlonkWithPoseidon fixtures at B=1024, np_small at
    NP_BATCH).  Returns, per fixture, {max_abs_err, ms, events_ms, plain_ms,
    bound_ms, bound_by} for both passes of one batch."""
    from recursive_stwo_tpu_torch.ops import poseidon_cuda
    from recursive_stwo_tpu_torch.tools.kernel_times import cuda_ms, profiled_ms
    from recursive_stwo_tpu_torch.tools.scan_cases import seeded_programs
    from recursive_stwo_tpu_torch.verifier.hashplan import scan_plain

    def run(prog):
        return poseidon_cuda.wordmajor_scan(prog.ops, prog.sources, prog.n_out, prog.n, prog.keep_capacity)

    def hold(label, prog) -> int:
        plain = scan_plain(prog)
        got = run(prog)
        torch.cuda.synchronize()
        require(torch.equal(got, plain), f"wordmajor_scan differs from scan_plain on {label}")
        return int((got - plain).abs().max())

    for n in SCAN_SLOTS_CHECKED:
        for lanes in range(1, 5):
            for label, prog in seeded_programs(n, lanes, SEED + n, dev):
                hold(f"seeded {label}, N={n}, {lanes} lanes", prog)
    print(f"wordmajor_scan: bit-exact vs scan_plain on seeded programs at N={SCAN_SLOTS_CHECKED} "
          f"with 1-4 lanes")

    result = {}
    for name, progs in programs.items():
        tot = dict(max_abs_err=0, ms=0.0, events_ms=0.0, plain_ms=0.0, bound_ms=0.0, permutations=0)
        for label, prog in progs:
            err = hold(f"{name} {label}", prog)
            perms = poseidon_cuda.scan_permutations(prog.ops, prog.n)
            bound, bound_by = poseidon_cuda.bound_ms(perms)
            ms = profiled_ms(torch, lambda: run(prog), 20, "wordmajor_scan")
            events_ms = cuda_ms(torch, lambda: run(prog), 20)
            plain_ms = cuda_ms(torch, lambda: scan_plain(prog), 2)
            print(f"wordmajor_scan {name} {label}: bit-exact vs scan_plain; "
                  f"{tuple(prog.ops.shape[:2])} lanes x steps, N={prog.n}, {perms} permutations; "
                  f"kernel {ms:.4f} ms device, {events_ms:.4f} ms per call back to back "
                  f"(bound {bound:.4f} ms by {bound_by}, {bound / ms:.1%}), plain {plain_ms:.4f} ms")
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            for k, v in (("ms", ms), ("events_ms", events_ms), ("plain_ms", plain_ms),
                         ("bound_ms", bound), ("permutations", perms)):
                tot[k] += v
        tot.update(bound_by=bound_by, library_ms=None)
        print(f"wordmajor_scan {name}, both passes: {tot['ms']:.4f} ms device against a bound of "
              f"{tot['bound_ms']:.4f} ms ({tot['bound_ms'] / tot['ms']:.1%})")
        result[name] = tot
    return result


def check_sha_kernel(torch, dev) -> dict:
    """Phase 3, the SHA-256 tree-level kernel: bit for bit against its plain
    version on the card (SHA_COLS_CHECKED x SHA_ROWS_CHECKED leaf levels,
    node levels with and without columns, a column slice) and against the
    native host SHA-256 at 2**20 leaves.  Returns {max_abs_err, ms,
    events_ms, plain_ms, bound_ms, bound_by} at a streamed leaf chunk
    (LAST_LAYER_WIDEST columns x SHA_CHUNK_ROWS rows), with node_* at a
    2**20-node level and big_* at a SHA_BIG_ROWS-row leaf level."""
    from recursive_stwo_tpu_torch.core import sha256
    from recursive_stwo_tpu_torch.ops import sha256_cuda
    from recursive_stwo_tpu_torch.tools.kernel_times import cuda_ms, profiled_ms
    from recursive_stwo_tpu_torch.utils import native

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand(shape, high):
        x = torch.randint(0, high, shape, generator=gen, device=dev, dtype=torch.int64)
        x[..., -1] = high - 1  # the largest word in the last entry of every row
        return x

    err = 0

    def hold(label, children, cols):
        nonlocal err
        got, plain = sha256_cuda.sha256_level(children, cols), sha256.sha256_level_plain(children, cols)
        torch.cuda.synchronize()
        require(torch.equal(got, plain), f"sha256_level differs from its plain version on {label}")
        err = max(err, int((got - plain).abs().max()))

    for n in SHA_ROWS_CHECKED:
        for n_cols in SHA_COLS_CHECKED:
            hold(f"a leaf level of {n_cols} columns x {n} rows", None, rand((n_cols, n), P))
        kids = rand((2 * n, 8), 2**32)
        hold(f"a node level of {n} nodes", kids, None)
        hold(f"a node level of {n} nodes with 4 columns", kids, rand((4, n), P))
    hold("a column slice of a larger block", None, rand((5, 3000), P)[:, 1000:2029])
    print(f"sha256_level: bit-exact vs plain on leaf levels of {SHA_COLS_CHECKED} columns and node levels "
          f"with 0 and 4 columns at {SHA_ROWS_CHECKED} rows, and on a column slice")

    require(native.sha_available(), "the native SHA-256 library is not available")
    n = SHA_CHUNK_ROWS
    cols, kids = rand((LAST_LAYER_WIDEST, n), P), rand((2 * n, 8), 2**32)
    host_cols = cols.cpu().numpy().astype(np.uint32)
    leaf = sha256_cuda.sha256_level(None, cols)
    require(np.array_equal(leaf.cpu().numpy().astype(np.uint32), native.sha256_leaf_level(host_cols)),
            "sha256_level differs from the native host SHA-256 on a leaf level")
    node = sha256_cuda.sha256_level(kids, cols[:4])
    require(np.array_equal(node.cpu().numpy().astype(np.uint32),
                           native.sha256_node_level(kids.cpu().numpy().astype(np.uint32), host_cols[:4])),
            "sha256_level differs from the native host SHA-256 on a node level")
    print(f"sha256_level: equal to the native host SHA-256 on {n} leaves of {LAST_LAYER_WIDEST} columns "
          f"and {n} nodes with 4 columns")

    out = dict(max_abs_err=err, library_ms=None)
    for key, children, c, reps in (("", None, cols, 20), ("node_", kids, None, 20)):
        ms = profiled_ms(torch, lambda: sha256_cuda.sha256_level(children, c), reps, "sha256_level")
        events_ms = cuda_ms(torch, lambda: sha256_cuda.sha256_level(children, c), reps)
        plain_ms = cuda_ms(torch, lambda: sha256.sha256_level_plain(children, c), 2)
        bound, bound_by = sha256_cuda.bound_ms(n, 0 if c is None else c.shape[0], children is not None)
        shape = f"({LAST_LAYER_WIDEST}, {n}) leaves" if children is None else f"{n} nodes"
        print(f"sha256_level {shape}: kernel {ms:.4f} ms device, {events_ms:.4f} ms per call back to back "
              f"(bound {bound:.4f} ms by {bound_by}, {bound / ms:.1%}), plain {plain_ms:.4f} ms")
        out.update({f"{key}ms": ms, f"{key}events_ms": events_ms, f"{key}plain_ms": plain_ms,
                    f"{key}bound_ms": bound, f"{key}bound_by": bound_by})
    del cols, kids, leaf, node, host_cols
    big = rand((4, SHA_BIG_ROWS), P)
    big_ms = profiled_ms(torch, lambda: sha256_cuda.sha256_level(None, big), 3, "sha256_level")
    big_bound, big_by = sha256_cuda.bound_ms(SHA_BIG_ROWS, 4, False)
    print(f"sha256_level (4, {SHA_BIG_ROWS}) leaves: kernel {big_ms:.4f} ms device (bound {big_bound:.4f} ms by "
          f"{big_by}, {big_bound / big_ms:.1%}); plain not measured (its 64 schedule words at this size "
          f"would take 64 GiB)")
    out.update(big_ms=big_ms, big_bound_ms=big_bound)
    del big
    torch.cuda.empty_cache()
    return out


def check_composition_kernels(torch, dev, lat: dict) -> tuple:
    """Phase 3, the composition kernels against their plain versions on the
    card, bit for bit.  The check kernel on the value and the bool: every
    verifier's fixture (tools/composition_cases.CHECK_FIXTURES) at
    COMP_BATCHES proofs, a sampled value corrupted in one slot, and random
    canonical inputs of the same spec (every constraint nonzero).  The
    domain kernel on each table of the demo circuits (both AIR pairs) and of
    chain level DOMAIN_LEVEL, table by table into one accumulator.  Returns
    ({max_abs_err, ms, events_ms, plain_ms, bound_ms, bound_by} of each) at
    the main path's shapes: the check at small_proof's B=1024 (np_*: phase
    10's B=512, sha_*: level 14's fast path at B=1) with its latency floor
    at `lat` (ops/latency_cuda.step_latencies), the domain kernel on level
    1's poseidon table (plonk_*: its plonk table)."""
    from recursive_stwo_tpu_torch.models import flagship
    from recursive_stwo_tpu_torch.ops import composition_cuda
    from recursive_stwo_tpu_torch.tools import composition_cases as cases
    from recursive_stwo_tpu_torch.tools.kernel_times import cuda_ms, profiled_ms

    err = 0

    def hold(label, case):
        nonlocal err
        (ok_k, v_k), (ok_p, v_p) = cases.check_value(case), cases.check_value(case, plain=True)
        torch.cuda.synchronize()
        require(torch.equal(ok_k, ok_p), f"composition_check's bool differs from its plain version on {label}")
        for got, want in zip(v_k, v_p):
            require(torch.equal(got, want), f"composition_check's value differs from its plain version on {label}")
            err = max(err, int((got - want).abs().max()))
        return ok_k.cpu()

    for name in cases.CHECK_FIXTURES:
        for batch in COMP_BATCHES:
            slot = batch // 2 if batch > 1 else None
            case = cases.check_case(name, batch, dev, corrupt_slot=slot)
            ok = hold(f"{name} at B={batch}", case)
            want = torch.ones(batch, dtype=torch.bool)
            if slot is not None:
                want[slot] = False
            require(torch.equal(ok, want), f"{name} at B={batch}: the check accepts {ok.tolist()}")
            hold(f"random inputs of {name}'s spec at B={batch}", cases.random_check_case(case.spec, batch, SEED + batch,
                                                                                        dev))
    print(f"composition_check: bit-exact vs plain (value and bool) on {cases.CHECK_FIXTURES} at B={COMP_BATCHES} "
          f"with a corrupted slot (rejected, every other slot accepted), and on random inputs of each spec")

    def timed(label, name, batch, reps=50):
        case = cases.check_case(name, batch, dev)
        ms = profiled_ms(torch, lambda: cases.check_value(case), reps, "composition_check")
        events_ms = cuda_ms(torch, lambda: cases.check_value(case), reps)
        plain_ms = cuda_ms(torch, lambda: cases.check_value(case, plain=True), 3)
        bound, bound_by = composition_cuda.check_bound_ms(case.spec, batch)
        floor = composition_cuda.latency_floor_ms(case.spec, lat)
        print(f"composition_check {label} ({name}, B={batch}): kernel {ms:.4f} ms device, {events_ms:.4f} ms per call "
              f"back to back (bound {bound:.6f} ms by {bound_by}, {bound / ms:.1%}; latency floor {floor:.6f} ms), "
              f"plain {plain_ms:.4f} ms")
        return dict(ms=ms, events_ms=events_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by, floor_ms=floor)

    check = timed("main path", FIXTURES[0], BATCH)
    check.update(max_abs_err=err, library_ms=None)
    for key, (label, name, batch) in (("np_", ("phase 10", "np_small", NP_BATCH)),
                                      ("sha_", ("fast path", "level14", 1))):
        check.update({f"{key}{k}": v for k, v in timed(label, name, batch).items() if k != "bound_by"})

    err = 0
    domain = {}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for label, trace, config, without_poseidon in (
        ("demo circuit", flagship.demo_trace(), flagship.DEMO_CONFIG, False),
        ("without-Poseidon demo circuit", _np_demo_trace(), flagship.DEMO_CONFIG, True),
        (f"chain level {DOMAIN_LEVEL}", *flagship.chain_level_trace(DOMAIN_LEVEL)[:2], False),
    ):
        t = time.perf_counter()
        spec, tables, lookup, rc = cases.prover_tables(trace, config, dev, without_poseidon)
        calls = cases.domain_calls(spec, tables)
        del tables
        n = 1 << spec.composition_log_degree_bound
        acc = torch.zeros((4, n), dtype=torch.int64, device=dev)
        for call in calls:
            air = composition_cuda.air_id(call.evaluate_fn)
            plain = cases.run_domain(call, acc, lookup, rc, plain=True)
            got = cases.run_domain(call, acc.clone(), lookup, rc)
            torch.cuda.synchronize()
            require(torch.equal(got, plain), f"composition_domain differs from its plain version on the {label}, "
                                             f"AIR {air}")
            err = max(err, int((got - plain).abs().max()))
            prev = torch.randint(0, P, tuple(acc.shape), generator=gen, device=dev, dtype=torch.int64)
            onto = call._replace(first=False)
            want = cases.run_domain(onto, prev, lookup, rc, plain=True)
            got = cases.run_domain(onto, prev.clone(), lookup, rc)
            require(torch.equal(got, want), f"composition_domain differs from its plain version on the {label}, "
                                            f"AIR {air}, accumulating into a random accumulator")
            err = max(err, int((got - want).abs().max()))
            if label.startswith("chain level"):
                work = acc.clone()
                ms = profiled_ms(torch, lambda: cases.run_domain(call, work, lookup, rc), 10, "composition_domain")
                events_ms = cuda_ms(torch, lambda: cases.run_domain(call, work, lookup, rc), 10)
                plain_ms = cuda_ms(torch, lambda: cases.run_domain(call, acc, lookup, rc, plain=True), 1)
                bound, bound_by = composition_cuda.domain_bound_ms(call.evaluate_fn, n, call.first)
                print(f"composition_domain {label}, AIR {air} ({call.pre.shape[0]} + {call.tr.shape[0]} + "
                      f"{call.inter.shape[0]} rows x {n} points): kernel {ms:.4f} ms device, {events_ms:.4f} ms per "
                      f"call back to back (bound {bound:.4f} ms by {bound_by}, {bound / ms:.1%}), plain "
                      f"{plain_ms:.4f} ms")
                key = "plonk_" if air == composition_cuda.PLONK else ""
                domain.update({f"{key}ms": ms, f"{key}events_ms": events_ms, f"{key}plain_ms": plain_ms,
                               f"{key}bound_ms": bound, f"{key}bound_by": bound_by})
                del work
            acc = plain
        print(f"composition_domain: bit-exact vs plain on the {label}'s {len(calls)} tables of {n} points, first "
              f"and accumulating ({time.perf_counter() - t:.1f} s with its stages before the composition)")
        del calls, acc, plain, got, want, prev
    torch.cuda.empty_cache()
    domain.update(max_abs_err=err, library_ms=None)
    return check, domain


def check_fold_kernel(torch, dev) -> dict:
    """Phase 3, the fold kernel against its plain version on the card, bit
    for bit: the answers, the self values and the last-layer check, on both
    fixtures at FOLD_BATCHES proofs, np_small at NP_BATCH and the SHA-256
    artifacts at SHA_BATCH, each with tools/fold_cases.CORRUPTIONS in four
    slots and on random canonical inputs of its shapes (slot 0's quotient
    denominators zero).  Returns {max_abs_err, ms, events_ms, plain_ms,
    bound_ms, bound_by} at the main path's shape (small_proof, B=1024;
    deep_*: recursive_proof_16_15's, np_*: phase 10's, sha_*: level 14's
    device checks at B=SHA_BATCH)."""
    from recursive_stwo_tpu_torch.ops import fold_cuda
    from recursive_stwo_tpu_torch.tools import fold_cases as cases
    from recursive_stwo_tpu_torch.tools.kernel_times import cuda_ms, profiled_ms

    err = 0
    parts = ("answers", "self values", "last-layer check")

    def hold(label, case):
        nonlocal err
        got, want = cases.fold_values(case), cases.fold_values(case, plain=True)
        torch.cuda.synchronize()
        for g, w, part in zip(got, want, parts):
            require(torch.equal(g, w), f"fold_phase's {part} differ from its plain version on {label}")
            if g.numel():
                err = max(err, int((g.long() - w.long()).abs().max()))
        return got[2].cpu()

    shapes = [(name, batch) for name in FIXTURES for batch in FOLD_BATCHES]
    shapes += [("np_small", NP_BATCH), ("level14", SHA_BATCH), ("bitcoin", SHA_BATCH)]
    for name, batch in shapes:
        ok = hold(f"{name} at B={batch}", cases.fold_case(name, batch, dev, corrupt=True))
        if batch > max(cases.CORRUPT_SLOTS):
            rejected = [b for b in range(batch) if not ok[b]]
            require(rejected == list(cases.CORRUPT_SLOTS), f"{name} at B={batch}: the fold rejects {rejected}")
        hold(f"random inputs of {name}'s shapes at B={batch}", cases.random_fold_case(name, batch, SEED + batch, dev))
    print(f"fold_phase: bit-exact vs plain (answers, self values, last-layer check) on {shapes}, each with "
          f"{', '.join(cases.CORRUPTIONS)} corrupted in slots {cases.CORRUPT_SLOTS} (rejected, every other slot "
          f"accepted), and on random inputs of each")

    def timed(label, name, batch, reps=50):
        case = cases.fold_case(name, batch, dev)
        ms = profiled_ms(torch, lambda: cases.fold_values(case), reps, "fold_kernel")
        events_ms = cuda_ms(torch, lambda: cases.fold_values(case), reps)
        plain_ms = cuda_ms(torch, lambda: cases.fold_values(case, plain=True), 3)
        bound, bound_by = fold_cuda.fold_bound_ms(case.spec, case.fs.raw_queries)
        print(f"fold_phase {label} ({name}, B={batch}): kernel {ms:.4f} ms device, {events_ms:.4f} ms per call "
              f"back to back (bound {bound:.6f} ms by {bound_by}, {bound / ms:.1%}), plain {plain_ms:.4f} ms")
        return dict(ms=ms, events_ms=events_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by)

    out = timed("main path", FIXTURES[0], BATCH)
    out.update(max_abs_err=err, library_ms=None)
    for key, (label, name, batch) in (("deep_", ("phase 5", FIXTURES[1], BATCH)),
                                      ("np_", ("phase 10", "np_small", NP_BATCH)),
                                      ("sha_", ("device checks", "level14", SHA_BATCH))):
        out.update({f"{key}{k}": v for k, v in timed(label, name, batch).items() if k != "bound_by"})
    return out


def check_transcript_kernel(torch, dev, lat: dict) -> dict:
    """Phase 3, the transcript kernel against its plain version on the card,
    bit for bit (every FSOutput field, the OODS point, the input sum, the
    PoW and total-sum checks): both fixtures at
    TRANSCRIPT_BATCHES proofs with a flipped nonce limb and a flipped
    commitment word in two slots and again with a wrong public input,
    np_small at NP_BATCH with its public inputs and with none, and random
    canonical inputs of each spec (an input term planted at zero in slot 0).
    `lat` is the latency probe's cycles a dependent step
    (ops/latency_cuda.step_latencies): the latency floor is a proof's chain
    of permutations in such steps (ops/transcript_cuda.latency_floor_ms).
    Returns {max_abs_err, ms, events_ms, plain_ms, bound_ms, bound_by,
    floor_ms} at the main path's shape (small_proof, B=1024;
    deep_*: recursive_proof_16_15's, np_*: phase 10's, b1_* and b512_*:
    small_proof at B=1 and 512)."""
    from recursive_stwo_tpu_torch.ops import transcript_cuda
    from recursive_stwo_tpu_torch.tools import transcript_cases as cases
    from recursive_stwo_tpu_torch.tools.kernel_times import cuda_ms, profiled_ms

    err = 0

    def hold(label, case):
        nonlocal err
        want = cases.replay_fields(case, plain=True)
        got = cases.replay_fields(case)
        torch.cuda.synchronize()
        require(list(got) == list(want), "transcript: outputs differ from the plain version's")
        for k, w in want.items():
            require(torch.equal(got[k], w), f"transcript differs from its plain version on {label}: {k}")
            if w.numel():
                err = max(err, int((got[k].long() - w.long()).abs().max()))
        return want

    nonce_slot, commit_slot = cases.CORRUPT_SLOTS
    labels = []
    for name in FIXTURES:
        for batch in TRANSCRIPT_BATCHES:
            want = hold(f"{name} at B={batch}, corrupted", cases.transcript_case(name, batch, dev, corrupt=True))
            if batch > commit_slot:
                pow_bad = [b for b in range(batch) if not want["pow"][b]]
                sum_bad = [b for b in range(batch) if not want["total_sum"][b]]
                require(pow_bad == [nonce_slot, commit_slot] and sum_bad == [commit_slot],
                        f"{name} at B={batch}: pow fails {pow_bad}, total_sum {sum_bad}")
            want = hold(f"{name} at B={batch}, a wrong public input",
                        cases.transcript_case(name, batch, dev, inputs=((1, (2, 0, 0, 0)),)))
            require(not want["total_sum"].any().item(), f"{name} at B={batch}: a wrong public input passes")
            hold(f"random inputs of {name}'s spec at B={batch}", cases.random_transcript_case(name, batch, SEED + batch,
                                                                                             dev))
            labels.append(f"{name} B={batch}")
    hold(f"np_small at B={NP_BATCH}", cases.transcript_case("np_small", NP_BATCH, dev))
    hold(f"np_small at B={NP_BATCH}, no public inputs", cases.transcript_case("np_small", NP_BATCH, dev, inputs=()))
    hold(f"random inputs of np_small's spec at B={NP_BATCH}", cases.random_transcript_case("np_small", NP_BATCH, SEED,
                                                                                           dev))
    print(f"transcript: bit-exact vs plain (every FSOutput field, the OODS point, the input sum, pow and total_sum) on {labels} with {', '.join(cases.CORRUPTIONS)} flipped in slots "
          f"{cases.CORRUPT_SLOTS} and with a wrong public input, on np_small at B={NP_BATCH} with and without public "
          f"inputs, and on random inputs of each spec (an input term zero in slot 0)")

    def timed(label, name, batch, reps=50):
        case = cases.transcript_case(name, batch, dev)

        def run():
            return transcript_cuda.transcript(case.spec, case.pa, case.inputs)

        ms = profiled_ms(torch, run, reps, "transcript_kernel")
        events_ms = cuda_ms(torch, run, reps)
        plain_ms = cuda_ms(torch, lambda: cases.replay_fields(case, plain=True), 3)
        bound, bound_by = transcript_cuda.transcript_bound_ms(case.spec, batch, len(case.inputs))
        floor = transcript_cuda.latency_floor_ms(case.spec, lat)
        perms = transcript_cuda.permutations(case.spec)
        steps = transcript_cuda.chain_steps(case.spec)
        print(f"transcript {label} ({name}, B={batch}, {perms} permutations a proof, {steps} on its chain): kernel "
              f"{ms:.4f} ms device, {events_ms:.4f} ms per call back to back (bound {bound:.6f} ms by {bound_by}, "
              f"{bound / ms:.1%}; latency floor {floor:.4f} ms = {steps} x "
              f"{transcript_cuda.permutation_cycles(lat):.0f} cycles), plain {plain_ms:.4f} ms")
        return dict(ms=ms, events_ms=events_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by, floor_ms=floor)

    out = timed("main path", FIXTURES[0], BATCH)
    out.update(max_abs_err=err, library_ms=None)
    for key, (label, name, batch) in (("deep_", ("phase 5", FIXTURES[1], BATCH)),
                                      ("np_", ("phase 10", "np_small", NP_BATCH)),
                                      ("b1_", ("the chain's batch", FIXTURES[0], 1)),
                                      ("b512_", ("half batch", FIXTURES[0], NP_BATCH))):
        out.update({f"{key}{k}": v for k, v in timed(label, name, batch).items() if k != "bound_by"})
    return out


def timed_kernel(torch, kind, label, run, plain, name, per_call, bound, reps) -> dict:
    """Phase 3: a kernel's device time under torch.profiler (the kernels
    whose name holds `name`, `per_call` of them a call), its time back to
    back under CUDA events and its plain version's time, beside its bound."""
    from recursive_stwo_tpu_torch.tools.kernel_times import cuda_ms, profiled_ms

    ms = profiled_ms(torch, run, reps, name, per_call)
    events_ms = cuda_ms(torch, run, reps)
    plain_ms = cuda_ms(torch, plain, 1)
    print(f"{kind} {label}: kernel {ms:.4f} ms device, {events_ms:.4f} ms per call back to back (bound "
          f"{bound[0]:.4f} ms by {bound[1]}, {bound[0] / ms:.1%}), plain {plain_ms:.4f} ms")
    return dict(ms=ms, events_ms=events_ms, plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1])


def check_prover_kernels(torch, dev) -> tuple:
    """Phase 3, the provers' circle FFT and quotient kernels against their
    plain versions on the card, bit for bit.  The whole-column transforms
    (interpolate, evaluate, the LDE to 2 and 8 times the size) at
    FFT_SHAPES, every interpolation and LDE of chain levels 1 and 2 at their
    shapes (tools/prover_cases.fft_cases) and an LDE of 17 columns to 2**27
    (its output passes 2**31 elements; its first and last column held to the
    plain version of each alone); the tile evaluation at TILE_SHAPES, at a
    tile of one coefficient, and on a streamed chunk of every first-layer
    group of level 2, level 14 and the last layer; the quotients of every
    first-layer group of levels 1 and 2 over its whole domain (and with the
    OODS point on the domain, its denominators zero), and of a streamed
    chunk of every group of level 14 and the last layer.  Returns
    ({max_abs_err, ms, events_ms, plain_ms, bound_ms, bound_by, library_ms}
    of each) at the main path's shapes: the FFT at level 2's largest LDE and
    interpolation, the tiles at the last layer's chunk, the quotients at
    level 2's groups (their sum; each group's beside it)."""
    from recursive_stwo_tpu_torch.ops import fft_cuda, quotients_cuda
    from recursive_stwo_tpu_torch.prover import circle_fft, tiles
    from recursive_stwo_tpu_torch.tools import prover_cases as cases

    gen = torch.Generator(device=dev).manual_seed(SEED)
    errs = dict(fft=0, tiles=0, quotients=0)

    def hold(kind, label, got, want):
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"{kind} differs from its plain version on {label}")
        errs[kind] = max(errs[kind], int((got - want).abs().max()) if got.numel() else 0)

    for log, cols in FFT_SHAPES:
        x = torch.randint(0, P, (cols, 1 << log), generator=gen, device=dev, dtype=torch.int64)
        hold("fft", f"interpolate ({cols}, 2**{log})", fft_cuda.interpolate(x), circle_fft.interpolate_plain(x))
        hold("fft", f"evaluate ({cols}, 2**{log})", fft_cuda.evaluate(x, log), circle_fft.evaluate_plain(x))
        for blowup in (1, 3):
            hold("fft", f"LDE ({cols}, 2**{log}) to 2**{log + blowup}", fft_cuda.evaluate(x, log + blowup),
                 circle_fft.evaluate_plain(circle_fft.extend(x, log + blowup)))
    for log, segments in LDE_SEGMENTS:
        x = torch.randint(0, P, (3, 1 << log), generator=gen, device=dev, dtype=torch.int64)
        out = log + segments.bit_length() - 1
        hold("fft", f"LDE (3, 2**{log}) to 2**{out}", fft_cuda.evaluate(x, out),
             circle_fft.evaluate_plain(circle_fft.extend(x, out)))
    specs = {name: cases.prover_spec(name) for name in PROVER_SHAPES}
    level_cases = {}
    for name in ("level1-5", "level2-1"):
        level_cases[name] = cases.fft_cases(specs[name], dev, SEED)
        for case in level_cases[name]:
            hold("fft", f"{name}'s {case.label}", cases.run_fft(case), cases.run_fft(case, plain=True))
    x = torch.randint(0, P, (17, 1 << 18), generator=gen, device=dev, dtype=torch.int64)
    big = fft_cuda.evaluate(x, 27)
    for col in (0, 16):
        hold("fft", f"column {col} of an LDE of (17, 2**18) to 2**27",
             big[col], circle_fft.evaluate_plain(circle_fft.extend(x[col:col + 1], 27))[0])
    del big, x
    torch.cuda.empty_cache()
    print(f"circle_fft: bit-exact vs plain (interpolate, evaluate, LDE x2 and x8) at {FFT_SHAPES} (log, columns), "
          f"LDEs at {LDE_SEGMENTS} (log, segments), on every transform of chain levels 1 and 2 at their shapes, and "
          f"on both ends of a (17, 2**27) LDE (2.3e9 elements)")

    for T, b, t0, t1, widths in TILE_SHAPES:
        blocks = [torch.randint(0, P, (w, 1 << b), generator=gen, device=dev, dtype=torch.int64) for w in widths]
        case = cases.TileCase(f"{widths} columns of 2**{b}, tiles [{t0}, {t1}) of 2**{T}", blocks,
                              tiles.circle_tiles(T, b, t0, t1, dev))
        hold("tiles", case.label, cases.run_tiles(case), cases.run_tiles(case, plain=True))
    one = torch.randint(0, P, (3, 1), generator=gen, device=dev, dtype=torch.int64)
    z = torch.zeros(7, dtype=torch.int64, device=dev)
    hold("tiles", "a tile of one coefficient", fft_cuda.eval_tiles([one], z, z, z[:1] + 1, z[:1]), one.expand(3, 7))
    for name in ("level2-1", "level14-1", "bitcoin_proof"):
        for g in range(len(specs[name].all_log_sizes)):
            case = cases.tile_case(specs[name], g, dev, SEED, chunk=1)
            hold("tiles", f"{name}'s {case.label}", cases.run_tiles(case), cases.run_tiles(case, plain=True))
    print(f"eval_tiles: bit-exact vs plain at {TILE_SHAPES} (T, b, tiles, columns), a tile of one coefficient, "
          f"and on chunk 1 of every first-layer group of level 2, level 14 and the last layer")

    for name in ("level1-5", "level2-1", "level14-1", "bitcoin_proof"):
        spec = specs[name]
        for g in range(len(spec.all_log_sizes)):
            resident = name.startswith("level1") or name.startswith("level2")
            case = cases.quotient_case(spec, g, dev, SEED + g, None if resident else cases.STREAM_CHUNK_LOG)
            hold("quotients", f"{name}'s {case.label}", cases.run_quotients(case),
                 cases.run_quotients(case, plain=True))
            if resident:
                x0, y0 = (int(v[0]) for v in case.points)
                on = case._replace(inputs=case.inputs._replace(oods=(x0, 0, 0, 0, y0, 0, 0, 0)))
                hold("quotients", f"{name}'s {case.label} with the OODS point on the domain",
                     cases.run_quotients(on), cases.run_quotients(on, plain=True))
    print("quotients: bit-exact vs plain on every first-layer group of levels 1 and 2 over its domain (and with the "
          "OODS point on the domain), and on a streamed chunk of every group of level 14 and the last layer")

    out = {}
    fft = {}
    for key, case in (("", max((c for c in level_cases["level2-1"] if c.log_out),
                               key=lambda c: c.x.shape[0] << c.log_out)),
                      ("interp_", max((c for c in level_cases["level2-1"] if not c.log_out),
                                      key=lambda c: c.x.numel()))):
        rows, n = case.x.shape
        b = n.bit_length() - 1
        segments = 1 << ((case.log_out or b) - b)
        r = timed_kernel(torch, "circle_fft", f"level 2's {case.label}", lambda: cases.run_fft(case),
                  lambda: cases.run_fft(case, plain=True), "fft_", fft_cuda.kernels_per_call(b),
                  fft_cuda.bound_ms(rows, b, segments, n, interpolate=not case.log_out), 10)
        fft.update({f"{key}{k}": v for k, v in r.items() if not (key and k == "bound_by")})
    out["circle_fft"] = dict(fft, max_abs_err=errs["fft"], library_ms=None)
    del level_cases

    spec = specs["bitcoin_proof"]
    g = max(range(len(spec.all_log_sizes)), key=lambda g: sum(quotients_cuda.group_tables(spec, g).widths))
    case = cases.tile_case(spec, g, dev, SEED)
    rows, b, G = sum(c.shape[0] for c in case.blocks), case.tiles.b, case.tiles.bx.shape[0]
    out["eval_tiles"] = dict(timed_kernel(torch, "eval_tiles", f"the last layer's {case.label}", lambda: cases.run_tiles(case),
                                   lambda: cases.run_tiles(case, plain=True), "fft_",
                                   fft_cuda.kernels_per_call(b, tiles=True),
                                   fft_cuda.bound_ms(rows, b, G, 1 << b, tiles=True), 10),
                             max_abs_err=errs["tiles"], library_ms=None)

    spec = specs["level2-1"]
    groups = []
    for g in range(len(spec.all_log_sizes)):
        case = cases.quotient_case(spec, g, dev, SEED + g)
        groups.append(timed_kernel(torch, "quotients", f"level 2's {case.label}", lambda: cases.run_quotients(case),
                            lambda: cases.run_quotients(case, plain=True), "quotient_",
                            quotients_cuda.KERNELS_PER_CALL, quotients_cuda.bound_ms(spec, g, 1 << spec.all_log_sizes[g]), 10))
        del case
    total = {k: sum(r[k] for r in groups) for k in ("ms", "events_ms", "plain_ms", "bound_ms")}
    print(f"quotients, level 2's {len(groups)} groups together: kernel {total['ms']:.4f} ms device (bound "
          f"{total['bound_ms']:.4f} ms, {total['bound_ms'] / total['ms']:.1%}), plain {total['plain_ms']:.4f} ms")
    out["quotients"] = dict(total, bound_by=groups[0]["bound_by"], groups_ms=[r["ms"] for r in groups],
                            groups_bound_ms=[r["bound_ms"] for r in groups], max_abs_err=errs["quotients"],
                            library_ms=None)
    torch.cuda.empty_cache()
    return out["circle_fft"], out["eval_tiles"], out["quotients"]


def check_sample_interaction(torch, dev) -> tuple:
    """Phase 3, the provers' sampling and interaction kernels against their
    plain versions on the card, bit for bit: the OODS samples of every block
    and point of SAMPLE_LEVELS' proofs (one launch each; seeded random
    coefficients at their shapes, tools/prover_cases.sample_case), a
    constant polynomial beside blocks of 2 and 2**13, one column of
    2**SAMPLE_BIG_LOG coefficients at two points, and a block with every
    coefficient and factor at p - 1; the interaction rows of each AIR table
    of SAMPLE_LEVELS (tools/prover_cases.interaction_cases), the plonk and
    without-Poseidon tables also with a zero denominator planted at
    ZERO_ROW.  Returns ({max_abs_err, ms, events_ms, plain_ms, bound_ms,
    bound_by, library_ms} of each) at level 1's shapes: a proof's samples
    in one call, and its two interaction tables summed."""
    from recursive_stwo_tpu_torch.ops import composition_cuda, interaction_cuda, sample_cuda
    from recursive_stwo_tpu_torch.prover.prove_host import _factors_at_point
    from recursive_stwo_tpu_torch.tools import prover_cases as cases

    gen = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    errs = dict(sample=0, interaction=0)

    def hold(kind, label, got, want):
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"{kind} differs from its plain version on {label}")
        errs[kind] = max(errs[kind], int((got - want).abs().max()) if got.numel() else 0)

    specs = {name: cases.prover_spec(name) for name in SAMPLE_LEVELS}
    sample_cases = {name: cases.sample_case(specs[name], dev, SEED) for name in SAMPLE_LEVELS}
    for name, case in sample_cases.items():
        hold("sample", f"{name}'s blocks ({case.label})", cases.run_sample(case), cases.run_sample(case, plain=True))

    def point():
        return tuple(tuple(int(v) for v in rng.integers(0, P, 4)) for _ in range(2))

    def job(cols, log, points, fill=None):
        c = torch.randint(0, P, (cols, 1 << log), generator=gen, device=dev, dtype=torch.int64)
        if fill is not None:
            return c.fill_(fill), [np.full((log, 4), fill, np.int64)] * points
        return c, [_factors_at_point(log, point()) for _ in range(points)]

    for label, jobs in (("a constant polynomial beside blocks of 2 and 2**13", [job(3, 0, 1), job(2, 1, 2),
                                                                                job(5, 13, 1)]),
                        (f"one column of 2**{SAMPLE_BIG_LOG} at two points", [job(1, SAMPLE_BIG_LOG, 2)]),
                        ("every coefficient and factor at p - 1", [job(4, 20, 2, fill=P - 1)])):
        case = cases.SampleCase(label, jobs)
        hold("sample", label, cases.run_sample(case), cases.run_sample(case, plain=True))
        del case, jobs
    torch.cuda.empty_cache()
    print(f"sample: bit-exact vs plain on every block and point of {SAMPLE_LEVELS}' OODS samples (one launch "
          f"each), a constant polynomial, one column of 2**{SAMPLE_BIG_LOG} coefficients and every value at p - 1")

    inter = {}
    for name in SAMPLE_LEVELS:
        inter[name] = cases.interaction_cases(specs[name], dev, SEED)
        planted = cases.interaction_cases(specs[name], dev, SEED, zero_row=ZERO_ROW)
        for case in inter[name] + [c for c in planted if "zero" in c.label]:
            hold("interaction", f"{name}'s {case.label}", cases.run_interaction(case),
                 cases.run_interaction(case, plain=True))
        del planted
    print(f"interaction: bit-exact vs plain on every AIR table of {SAMPLE_LEVELS} (and with a zero denominator "
          f"planted at row {ZERO_ROW} of the plonk and without-Poseidon tables)")

    case = sample_cases["level1-5"]
    out_sample = dict(timed_kernel(torch, "sample", f"level 1's OODS samples ({case.label})", lambda: cases.run_sample(case),
                            lambda: cases.run_sample(case, plain=True), "sample_", sample_cuda.KERNELS_PER_CALL,
                            sample_cuda.bound_ms(sample_cuda.job_shapes(case.jobs)), 20),
                      max_abs_err=errs["sample"], library_ms=None)
    tables = []
    for case in inter["level1-5"]:
        air = composition_cuda.air_id(case.evaluate_fn)
        tables.append(timed_kernel(torch, "interaction", f"level 1's {case.label}", lambda: cases.run_interaction(case),
                            lambda: cases.run_interaction(case, plain=True), "interaction_kernel", 1,
                            interaction_cuda.bound_ms(air, case.pre.shape[1]), 20))
    total = {k: sum(r[k] for r in tables) for k in ("ms", "events_ms", "plain_ms", "bound_ms")}
    print(f"interaction, level 1's {len(tables)} tables together: kernel {total['ms']:.4f} ms device (bound "
          f"{total['bound_ms']:.4f} ms, {total['bound_ms'] / total['ms']:.1%}), plain {total['plain_ms']:.4f} ms")
    out_inter = dict(total, bound_by=tables[0]["bound_by"], tables_ms=[r["ms"] for r in tables],
                     tables_bound_ms=[r["bound_ms"] for r in tables], max_abs_err=errs["interaction"],
                     library_ms=None)
    del sample_cases, inter
    torch.cuda.empty_cache()
    return out_sample, out_inter


def check_fri_merkle(torch, dev) -> tuple:
    """Phase 3, the provers' FRI fold-layer and Merkle level kernels against
    their plain versions on the card, bit for bit: fold layers at FOLD_LOGS
    (line, join alone and both) and every fold launch of PROVER_SHAPES'
    proofs (tools/prover_cases.fold_shapes: the last layer's first is a
    circle fold of (4, 2**27)); Merkle leaf and node levels with
    MERKLE_COLS columns at MERKLE_ROWS nodes, a streamed chunk's strided
    column view, and a 2**MERKLE_BIG_LOG-leaf level of 4 columns (held to
    the plain version MERKLE_BLOCK rows at a time).  Returns ({max_abs_err,
    ms, events_ms, plain_ms, bound_ms, bound_by, library_ms} of each) at
    level 1's shapes: a proof's fold launches summed, and its tree-1 leaf
    level (2**20 nodes of 12 columns), with level 2's tree-1 leaf level and a
    streamed chunk of it beside it."""
    from recursive_stwo_tpu_torch.ops import fri_fold_cuda, merkle_cuda
    from recursive_stwo_tpu_torch.tools import prover_cases as cases

    errs = dict(fri_fold=0, merkle_level=0)

    def hold(kind, label, got, want):
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"{kind} differs from its plain version on {label}")
        errs[kind] = max(errs[kind], int((got - want).abs().max()) if got.numel() else 0)

    kinds = ((True, False), (False, True), (True, True))
    for log in FOLD_LOGS:
        for line, circle in kinds:
            case = cases.fold_case(log, line, circle, dev, SEED + log)
            hold("fri_fold", case.label, cases.run_fold(case), cases.run_fold(case, plain=True))
    specs = {name: cases.prover_spec(name) for name in PROVER_SHAPES}
    for name, spec in specs.items():
        for k, (log, line, circle) in enumerate(cases.fold_shapes(spec)):
            case = cases.fold_case(log, line, circle, dev, SEED + k)
            hold("fri_fold", f"{name}'s layer {k}, {case.label}", cases.run_fold(case),
                 cases.run_fold(case, plain=True))
            del case
        torch.cuda.empty_cache()
    print(f"fri_fold: bit-exact vs plain at logs {FOLD_LOGS} (line, join, both) and at every fold launch of "
          f"{PROVER_SHAPES}' proofs (their first layers up to a circle fold of (4, 2**27))")


    def hold_level(label, case, block=None):
        hold("merkle_level", label, cases.run_merkle(case), cases.run_merkle(case, plain=True, block=block))

    for n_cols in MERKLE_COLS:
        for rows in MERKLE_ROWS:
            log = (rows - 1).bit_length()
            for node in (False, True):
                if n_cols or node:
                    case = cases.merkle_case(n_cols, log, dev, SEED + rows, node=node, rows=rows)
                    hold_level(case.label, case)
    case = cases.merkle_tree_case(specs["level2-1"], 1, dev, SEED, rows=(1 << 20) + 3)
    hold_level(case.label + " (a strided view)", case)
    case = cases.merkle_case(4, MERKLE_BIG_LOG, dev, SEED)
    hold_level(case.label, case, MERKLE_BLOCK)
    del case
    torch.cuda.empty_cache()
    print(f"merkle_level: bit-exact vs plain with {MERKLE_COLS} columns at {MERKLE_ROWS} nodes (leaf and node "
          f"levels), on a strided column view, and on a 2**{MERKLE_BIG_LOG}-leaf level of 4 columns")

    spec = specs["level1-5"]
    folds = [cases.fold_case(log, line, circle, dev, SEED + k)
             for k, (log, line, circle) in enumerate(cases.fold_shapes(spec))]
    bound = sum(fri_fold_cuda.bound_ms(c.log_size, c.g is not None, c.join is not None)[0] for c in folds)
    out_fold = dict(timed_kernel(torch, "fri_fold", f"level 1's {len(folds)} fold launches",
                                 lambda: [cases.run_fold(c) for c in folds],
                                 lambda: [cases.run_fold(c, plain=True) for c in folds], "fri_layer_kernel",
                                 len(folds), (bound, "bytes"), 20),
                    max_abs_err=errs["fri_fold"], library_ms=None)
    del folds
    merkle = {}
    for key, label, case in (("", "level 1's", cases.merkle_tree_case(spec, 1, dev, SEED)),
                             ("level2_", "level 2's", cases.merkle_tree_case(specs["level2-1"], 1, dev, SEED)),
                             ("chunk_", "a streamed chunk of level 2's",
                              cases.merkle_tree_case(specs["level2-1"], 1, dev, SEED, rows=1 << 20))):
        r = timed_kernel(torch, "merkle_level", f"{label} {case.label}", lambda: cases.run_merkle(case),
                         lambda: cases.run_merkle(case, plain=True), "merkle_level_kernel", 1,
                         merkle_cuda.bound_ms(int(case.cols.shape[0]), False, case.n), 10)
        merkle.update({f"{key}{k}": v for k, v in r.items() if not (key and k == "bound_by")})
        del case
    out_merkle = dict(merkle, max_abs_err=errs["merkle_level"], library_ms=None)
    torch.cuda.empty_cache()
    return out_fold, out_merkle


def check_fri_last(torch, dev) -> dict:
    """Phase 3, the provers' FRI last-layer kernel against its plain version
    on the card, bit for bit (the kept coefficients in the verifier's order,
    every count 0): last layers at LAST_SHAPES and at PROVER_SHAPES'
    (tools/prover_cases.last_layer_case), each also with three coefficients
    planted past the bound, which the kernel must count in every column and
    last_layer_poly refuse.  Returns {max_abs_err, ms, events_ms, plain_ms,
    bound_ms, bound_by, library_ms} at chain_level12's last layer ((4,
    2**16), bound 7)."""
    from recursive_stwo_tpu_torch.ops import fri_fold_cuda
    from recursive_stwo_tpu_torch.prover import fri_last
    from recursive_stwo_tpu_torch.tools import prover_cases as cases

    err = 0

    def hold(label, got, want):
        nonlocal err
        require(torch.equal(got, want), f"fri_last differs from its plain version on {label}")
        err = max(err, int((got - want).abs().max()))

    last_shapes = list(LAST_SHAPES)
    for spec in map(cases.prover_spec, PROVER_SHAPES):
        shape = (spec.max_first_layer_log - 1 - spec.n_inner_layers, spec.log_last_layer_degree_bound)
        if shape not in last_shapes:
            last_shapes.append(shape)
    for level, bound in last_shapes:
        case = cases.last_layer_case(level, bound, dev, SEED + level)
        words = cases.run_last(case).cpu()
        want = torch.as_tensor(cases.run_last(case, plain=True).astype(np.int64)).reshape(-1)
        hold(case.label, words[: 4 << bound], want)
        counts = words[4 << bound :].tolist()
        require(counts == [0] * 4, f"fri_last counts {counts} on {case.label}, a layer within the bound")
        n = 1 << level
        planted = sorted(p for p in {1 << bound, n // 2 + 1, n - 1} if 1 << bound <= p < n)
        if planted:
            case = cases.last_layer_case(level, bound, dev, SEED + level, planted=planted)
            counts = cases.run_last(case)[4 << bound :].tolist()
            require(counts == [len(planted)] * 4, f"fri_last counts {counts} on {case.label}, expected {len(planted)}")
            try:
                fri_last.last_layer_poly(case.g, level, bound)
            except ValueError as e:
                require(str(e) == fri_last.DEGREE_ERROR, f"fri_last: {case.label} raised {e}")
            else:
                require(False, f"fri_last: last_layer_poly accepted {case.label}")
    del case
    print(f"fri_last: bit-exact vs plain at (level, bound) {last_shapes}, every count 0; coefficients planted past "
          f"the bound counted in every column and refused by last_layer_poly")
    case = cases.last_layer_case(*LAST_SHAPES[0], dev, SEED)
    out = dict(timed_kernel(torch, "fri_last", case.label, lambda: cases.run_last(case),
                            lambda: cases.run_last(case, plain=True), "fri_last_kernel", 1,
                            fri_fold_cuda.last_bound_ms(case.level, case.bound), 50),
               max_abs_err=err, library_ms=None)
    del case
    torch.cuda.empty_cache()
    return out


def _failing(checks: dict, slot: int) -> list:
    return sorted(k for k, v in checks.items() if not bool(v[slot]))


def hold_batch(torch, dev, label: str, run, pa, inputs) -> tuple:
    """Phases 4, 5 and 10.  `pa` is a numpy batch with a flipped sibling
    hash (tree 1) in SIB_SLOT and a flipped nonce in NONCE_SLOT; run(pa,
    inputs) is the verifier.  On CUDA and on the CPU, with the batch's
    inputs and with a wrong first public input, every named check of every
    slot must agree; the corrupted slots must fail by their checks.  Returns
    the kernels' launch counts over one run on CUDA, and the CPU run's
    checks with the batch's inputs."""
    from recursive_stwo_tpu_torch.ops import launches as kernel_launches
    from recursive_stwo_tpu_torch.verifier.arrays import to_torch

    batch = pa.commitments.shape[0]
    pa_d = to_torch(pa, dev)
    pa_host = to_torch(pa, "cpu")
    torch.cuda.synchronize()

    kernel_launches.reset()
    checks = run(pa_d, inputs)
    torch.cuda.synchronize()
    launches = kernel_launches.counts()
    require(launches["transcript"] == 1 and launches["permute_rows"] == 0,
            f"{label}: expected 1 launch of the transcript kernel and none of K1, got {launches}")
    require(launches["wordmajor_scan"] == 2 and launches["permute_wordmajor"] == 1,
            f"{label}: expected 2 scan launches and 1 K2 leaf step, got {launches}")
    require(launches["composition_check"] == 1 and launches["composition_domain"] == 0,
            f"{label}: expected 1 launch of the composition check kernel, got {launches}")
    require(launches["fold_phase"] == 1, f"{label}: expected 1 launch of the fold kernel, got {launches}")

    wrong_inputs = ((inputs[0][0], (2, 0, 0, 0)),) + tuple(inputs[1:])
    for case, inp in (("batch inputs", inputs), ("wrong public input", wrong_inputs)):
        got = checks if inp is inputs else run(pa_d, inp)
        t = time.perf_counter()
        ref = run(pa_host, inp)
        host_s = time.perf_counter() - t
        require(list(got) == list(ref), f"{label}: check names differ from the host run")
        for k in ref:
            g = got[k].cpu()
            require(g.shape == (batch,) and torch.equal(g, ref[k]),
                    f"{label} ({case}): check {k} differs from the host run")
        ok = got["ok"].cpu().numpy()
        if inp is inputs:
            host_checks = ref
            clean = np.ones(batch, bool)
            clean[[SIB_SLOT, NONCE_SLOT]] = False
            require(ok[clean].all(), f"{label}: a clean slot was rejected")
            require(_failing(got, SIB_SLOT) == ["ok", "tree1"],
                    f"{label}: sibling flip fails {_failing(got, SIB_SLOT)}")
            require(not got["pow"][NONCE_SLOT] and not ok[NONCE_SLOT], f"{label}: nonce flip accepted")
        else:
            require(not got["total_sum"].any().item() and not ok.any(),
                    f"{label}: wrong public input accepted")
        print(f"{label} B={batch} ({case}): all {len(ref)} checks equal the CPU run "
              f"({host_s:.1f} s) per slot; {int(ok.sum())} slots ok")
    print(f"{label}: kernel launches in one run: {launches}")
    return launches, host_checks


def _corrupted(pa):
    pa.tree_paths[1].sibling_hashes[SIB_SLOT, 0, 0, 0] ^= np.uint32(1)
    pa.nonce_limbs[NONCE_SLOT] ^= np.uint32(1)
    return pa


def check_main_path(torch, dev, name: str) -> tuple:
    """Phases 4 and 5: verify_batch on a fixture at B=1024 (hold_batch)."""
    from recursive_stwo_tpu_torch.models import flagship
    from recursive_stwo_tpu_torch.verifier import verify

    spec, pa1 = flagship.prepared_arrays(name)
    pa = _corrupted(flagship.tiled_batch(pa1, BATCH))
    return hold_batch(torch, dev, name, lambda a, inp: verify.verify_batch(spec, a, inp), pa,
                      flagship.FIXTURE_INPUTS[name])


def check_np_path(torch, dev) -> tuple:
    """Phase 10: verify_batch_np on np_small at B=NP_BATCH (hold_batch)."""
    from recursive_stwo_tpu_torch.models import flagship
    from recursive_stwo_tpu_torch.verifier.verify_np import verify_batch_np

    spec, pa1 = flagship.prepared_arrays_np("np_small")
    pa = _corrupted(flagship.tiled_batch(pa1, NP_BATCH))
    return hold_batch(torch, dev, "np_small", lambda a, inp: verify_batch_np(spec, a, inp), pa,
                      flagship.NP_FIXTURE_INPUTS["np_small"])


def _median_rate(torch, label: str, step, arrays, batch: int, runs: int = 5) -> float:
    """Warm proofs/s: the median of `runs` synchronised calls of step on a
    device-resident clean batch (the host-to-device copy is not timed)."""
    require(bool(step(arrays)["ok"].all()), f"{label}: clean batch rejected")
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(arrays)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    med = statistics.median(times)
    print(f"{label} B={batch}: {med * 1e3:.1f} ms median of {runs} "
          f"({', '.join(f'{s * 1e3:.1f}' for s in times)} ms) = {batch / med:.1f} proofs/s")
    return batch / med


def proofs_per_s(torch, dev, name: str) -> float:
    """Phase 6: warm proofs/s of verify_batch at B=1024."""
    from recursive_stwo_tpu_torch.models import flagship

    step, arrays = flagship.verifier_step(name, BATCH, device=dev)
    return _median_rate(torch, f"{name} verify_batch", step, arrays, BATCH)


def phase_ms(torch, dev, name: str, runs: int = 5) -> dict:
    """Phase 6: the walls of the transcript, the fold phase, the hash phase
    and the composition check per verify_batch at B=1024 (warm, median of
    `runs`), each bounded by synchronize() on both sides.  Separate runs
    from the proofs/s ones, whose pipeline these syncs would cut."""
    from recursive_stwo_tpu_torch.models import flagship
    from recursive_stwo_tpu_torch.tools.verify_times import phase_walls
    from recursive_stwo_tpu_torch.verifier import composition, transcript, verify

    step, arrays = flagship.verifier_step(name, BATCH, device=dev)
    out = {}
    for label, owner, attr in (("transcript", transcript, "replay"), ("fold phase", verify, "fold_phase"),
                               ("hash phase", verify, "hash_phase"),
                               ("composition", composition, "composition_check")):
        times = phase_walls(torch, step, arrays, runs + 1, owner, attr)[1:]
        med = statistics.median(times)
        print(f"{name} B={BATCH}: {label} {med * 1e3:.2f} ms median of {runs} "
              f"({', '.join(f'{s * 1e3:.2f}' for s in times)} ms)")
        out[label] = med * 1e3
    return out


def check_demo_proof(torch, dev) -> None:
    """Phase 7, first: the demo circuit proved on CUDA and on the CPU (plain
    permutations) by the port; the bytes must agree."""
    from recursive_stwo_tpu_torch.models import flagship
    from recursive_stwo_tpu_torch.ops import launches
    from recursive_stwo_tpu_torch.prover.prove import prove

    trace = flagship.demo_trace()
    config = flagship.DEMO_CONFIG
    t = time.perf_counter()
    launches.reset()
    on_card = flagship.proof_bytes(prove(trace, config, device=dev))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t
    got = launches.counts()
    require(got["fri_last"] == 1 and got["p31_grind"] == 1 and got["permute_rows"] == 0,
            f"demo proof: expected 1 fri_last launch, 1 p31_grind launch and no permute_rows launch, got {got}")
    t = time.perf_counter()
    on_cpu = flagship.proof_bytes(prove(trace, config, device="cpu"))
    require(on_card == on_cpu, "demo proof on CUDA differs from the CPU run")
    print(f"demo circuit: proof on CUDA ({card_s:.2f} s) equals the CPU run "
          f"({time.perf_counter() - t:.2f} s), {len(on_card)} bytes")


def print_timing(label: str, r: dict) -> None:
    """Phases 7, 8, 12, 13 and 15: a proof's wall, peak, launches, the
    SHA-256 kernel's and the copies' device time under a trace, and stages
    (a record of tools/chain.timed_proof)."""
    print(f"{label}: proving wall {r['prove_s']:.3f} s; peak device memory {r['peak_gib']:.3f} GiB "
          f"({r['peak_bytes']} bytes; {r['start_bytes']} held at the start); kernel launches {r['prove_launches']}")
    if "cuda_kernels" in r:
        print(f"{label}: {r['cuda_kernels']} CUDA kernels on the card under the trace, "
              f"{r['cuda_kernels'] - r['hand_written_kernels']} of them eager torch "
              f"({r['hand_written_kernels']} hand-written); "
              f"{r['copies_and_fills']} copies and fills; kernels busy {r['busy_ms']:.1f} ms, "
              f"{r['busy_ms'] / 1e3 / r['prove_s']:.1%} of the traced proving wall")
    if r.get("sha256_ms"):
        print(f"{label}: the SHA-256 kernel {r['sha256_ms']:.1f} ms of device time under the trace; "
              f"copies from the card to the host {r['dtoh_ms']:.1f} ms (the SHA-256 trees' digests among them)")
    for s in r["stages"]:
        print(f"{label}:   {s['s']:8.3f} s  {s['stage']}")


def prove_level(dev, level: int, seen: set, proof_in=None, streamed: bool = False) -> dict:
    """Phases 7, 8, 12 and 15: chain level `level` (tools/chain.LAST: the
    last layer) built, proved and verified on CUDA by tools/chain.run_level,
    which holds its bytes to the digest docs/chain_artifacts.txt lists for
    its .bin; that digest must be LEVEL_SHA256's.  The Merkle level kernel
    must launch at levels 1-3 and K1 never (their PoW is one launch of the
    Poseidon31 grind kernel), the SHA-256 kernel at the last layer, and the fold-layer kernel
    spec.n_inner_layers + 1 times in every flavour.  Streamed proofs run under
    a device-only trace that counts the card's kernels.  Returns the
    level's record (tools/chain.run_level)."""
    from recursive_stwo_tpu_torch.models import flagship
    from recursive_stwo_tpu_torch.tools import chain, prover_cases
    from recursive_stwo_tpu_torch.verifier.spec import NoPoseidonVerifierSpec, VerifierSpec

    label = ("last layer" if level == chain.LAST else f"level {level}") + (", streamed" if streamed else "")
    name = chain.level_name(level)
    expected = flagship.expected_sha256(name)
    require(expected == LEVEL_SHA256[level], f"{label}: docs/chain_artifacts.txt lists {expected} for {name}.bin")
    proof, r = chain.run_level(level, proof_in, None, dev, seen, streamed=streamed, count_kernels=True)
    print(f"{label}: circuit of {r['rows']} rows and {r['public_inputs']} public inputs built on the host in "
          f"{r['circuit_s']:.2f} s; pow {r['pow_bits']}, FRI {r['fri']}")
    print_timing(label, r)
    got = r["prove_launches"]
    require((got["sha256_grind"], got["p31_grind"]) == (int(level == chain.LAST), int(level != chain.LAST)),
            f"{label}: expected the PoW in one launch of its channel's grind kernel (sha256_grind at the last "
            f"layer, p31_grind before), got {got}")
    if level == chain.LAST:
        require(got["sha256_level"] > 0, f"{label}: sha256_level never launched while proving")
    elif level <= 3:
        # the Merkle level kernel hashes every Poseidon31 tree and the grind
        # kernel grinds the PoW of levels 1-3 (20 bits), so K1 never runs
        require(got["merkle_level"] > 0 and got["permute_rows"] == 0,
                f"{label}: expected merkle_level launches and no permute_rows launch while proving, got {got}")
    tables = 1 if level == chain.LAST else 2
    require(r["prove_launches"]["composition_domain"] == tables,
            f"{label}: expected {tables} composition_domain launches (one an AIR table), got {r['prove_launches']}")
    spec = (NoPoseidonVerifierSpec.for_rows(proof.log_size, proof.config) if level == chain.LAST
            else VerifierSpec.from_proof(proof))
    require(got["fri_fold"] == spec.n_inner_layers + 1 and got["fri_last"] == 1,
            f"{label}: expected {spec.n_inner_layers + 1} fri_fold launches (one a FRI layer and the first) and 1 "
            f"fri_last launch, got {got}")
    quotient_calls = prover_cases.n_chunks(spec) if streamed else len(spec.all_log_sizes)
    require(got["circle_fft"] > 0 and got["quotients"] == quotient_calls and (got["eval_tiles"] > 0) == streamed,
            f"{label}: expected circle_fft launches, {quotient_calls} quotient launches (one a "
            f"{'streamed chunk' if streamed else 'first-layer group'}) and eval_tiles launches "
            f"{'' if streamed else 'none '}while proving, got {got}")
    require(got["sample"] == 1 and got["interaction"] == tables,
            f"{label}: expected 1 sample launch and {tables} interaction launches (one an AIR table), got {got}")
    del proof
    print(f"{label}: proof equals {name}.bin byte for byte ({r['bytes']} bytes, sha256 {r['sha256']}); "
          f"the port's verifier on CUDA accepts it ({r['verify_s']:.2f} s)")
    return r


def check_demo_sha_proof(dev) -> None:
    """Phase 13: prove_sha256p31 of the demo circuit on CUDA and on the CPU;
    the "bytes32" bytes must agree."""
    from recursive_stwo_tpu_torch.models import flagship
    from recursive_stwo_tpu_torch.prover.prove_sha256 import prove_sha256p31
    from recursive_stwo_tpu_torch.tools.chain import timed_proof
    from recursive_stwo_tpu_torch.verifier.spec import VerifierSpec

    trace = flagship.demo_trace()
    config = flagship.DEMO_CONFIG
    proof, timing = timed_proof(lambda progress: prove_sha256p31(trace, config, progress, dev), dev)
    print_timing("demo circuit, prove_sha256p31", timing)
    require(timing["prove_launches"]["composition_domain"] == 2,
            f"demo prove_sha256p31: expected 2 composition_domain launches, got {timing['prove_launches']}")
    spec = VerifierSpec.from_proof(proof)
    require(timing["prove_launches"]["fri_fold"] == spec.n_inner_layers + 1
            and timing["prove_launches"]["fri_last"] == 1 and timing["prove_launches"]["merkle_level"] == 0,
            f"demo prove_sha256p31: expected {spec.n_inner_layers + 1} fri_fold launches, 1 fri_last launch and no "
            f"merkle_level launch (SHA-256 trees), got {timing['prove_launches']}")
    on_card = flagship.proof_bytes(proof)
    t = time.perf_counter()
    on_cpu = flagship.proof_bytes(prove_sha256p31(trace, config, device="cpu"))
    require(on_card == on_cpu, "the demo prove_sha256p31 on CUDA differs from the CPU run")
    print(f"demo circuit, prove_sha256p31: proof on CUDA equals the CPU run ({time.perf_counter() - t:.2f} s), "
          f"{len(on_card)} bytes, sha256 {hashlib.sha256(on_card).hexdigest()}")


def _np_demo_trace():
    """A small PlonkWithoutPoseidon circuit (a QM31 square-and-add check),
    as tests/test_torch_chain.py proves."""
    from recursive_stwo_tpu_torch.cs.system import PlonkWithoutPoseidonCS
    from recursive_stwo_tpu_torch.gadgets.fields import QM31Var

    cs = PlonkWithoutPoseidonCS()
    x = QM31Var.new_witness(cs, (5, 6, 7, 8))
    y = (x * x) + x
    y.equalverify(y)
    cs.pad()
    cs.check_arithmetics()
    cs.populate_logup_arguments()
    return cs.generate_trace()


def check_streamed_demo(torch, dev) -> None:
    """Phase 15 (a): the four streamed demo proofs on CUDA against the CPU."""
    from recursive_stwo_tpu_torch.models import flagship
    from recursive_stwo_tpu_torch.ops import launches
    from recursive_stwo_tpu_torch.prover.commit import Sha256DeviceTree
    from recursive_stwo_tpu_torch.prover.prove_sha256 import Sha256ProverChannel
    from recursive_stwo_tpu_torch.prover.stream import prove_np_streamed, prove_streamed
    from recursive_stwo_tpu_torch.verifier.spec import NoPoseidonVerifierSpec, VerifierSpec

    demo, np_demo = flagship.demo_trace(), _np_demo_trace()
    cases = (
        ("prove_streamed, Poseidon31", lambda d: prove_streamed(demo, flagship.DEMO_CONFIG, device=d, **STREAM_DEMO)),
        ("prove_streamed, Sha256Poseidon31", lambda d: prove_streamed(
            demo, flagship.DEMO_CONFIG, device=d, channel=Sha256ProverChannel(), tree_cls=Sha256DeviceTree,
            **STREAM_DEMO)),
        ("prove_np_streamed, Poseidon31", lambda d: prove_np_streamed(
            np_demo, flagship.DEMO_CONFIG, device=d, **STREAM_DEMO)),
        ("prove_np_streamed, Sha256MerkleChannel", lambda d: prove_np_streamed(
            np_demo, flagship.DEMO_CONFIG, device=d, channel=Sha256ProverChannel(), tree_cls=Sha256DeviceTree,
            **STREAM_DEMO)),
    )
    for label, fn in cases:
        t = time.perf_counter()
        launches.reset()
        proof = fn(dev)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t
        got = launches.counts()
        spec = (NoPoseidonVerifierSpec.for_rows(proof.log_size, proof.config) if hasattr(proof, "log_size")
                else VerifierSpec.from_proof(proof))
        sha = "Sha256" in label
        require(got["fri_fold"] == spec.n_inner_layers + 1 and got["fri_last"] == 1
                and (got["merkle_level"] > 0) != sha and got["permute_rows"] == 0
                and (got["sha256_grind"], got["p31_grind"]) == (int(sha), int(not sha)),
                f"demo {label}: expected {spec.n_inner_layers + 1} fri_fold launches, 1 fri_last launch, "
                f"merkle_level launches {'none' if sha else 'some'}, no permute_rows launch and one launch of "
                f"the {'SHA-256' if sha else 'Poseidon31'} grind, got {got}")
        on_card = flagship.proof_bytes(proof)
        t = time.perf_counter()
        on_cpu = flagship.proof_bytes(fn("cpu"))
        require(on_card == on_cpu, f"demo {label} on CUDA differs from the CPU run")
        print(f"demo {label} at {STREAM_DEMO}: proof on CUDA ({card_s:.2f} s) equals the CPU run "
              f"({time.perf_counter() - t:.2f} s), {len(on_card)} bytes")


def check_streamed(torch, dev, seen: set, resident: dict) -> dict:
    """Phase 15.  `resident` holds phase 8's level-3 and phase 12's
    last-layer records.  Returns the launches of (b) and (c)."""
    from recursive_stwo_tpu_torch.models import flagship
    from recursive_stwo_tpu_torch.tools import chain

    check_streamed_demo(torch, dev)
    out = {}
    for level, proof_in in ((3, None), (chain.LAST, flagship.sha_artifact("level14"))):
        r = prove_level(dev, level, seen, proof_in, streamed=True)
        res = resident[level]
        label = "last layer" if level == chain.LAST else f"level {level}"
        print(f"{label}: peak device memory streamed {r['peak_gib']:.3f} GiB ({r['own_peak_gib']:.3f} GiB above the "
              f"{r['start_bytes'] / 2**30:.3f} GiB held at its start) against {res['peak_gib']:.3f} GiB resident "
              f"({res['own_peak_gib']:.3f} above {res['start_bytes'] / 2**30:.3f}) in this run; proving wall streamed "
              f"{r['prove_s']:.3f} s (traced) against {res['prove_s']:.3f} s resident")
        require(r["peak_bytes"] - r["start_bytes"] < res["peak_bytes"] - res["start_bytes"],
                f"{label}: the streamed proof's own peak is not below the resident one's")
        out[level] = r["prove_launches"]
    return out


def check_grind(torch, dev) -> tuple:
    """Phase 9: the Poseidon31 grind kernel against grind_device (K1 on
    blocks of 2**22 states, K1's main path since the provers' trees and
    grind left it) and the host native scan at GRIND_BITS on seeded digests
    (seed SEED + bits), one launch a grind and no K1; the three times of
    each, and the kernel's device time at the last bits beside
    grind_bound_ms of the nonces up to the hit (the kernel scans a little
    more: the chunks in flight).  Returns (grind_device's launches at the
    first bits, {nonce, ms, events_ms, plain_ms, bound_ms, bound_by,
    host_ms, max_abs_err, library_ms} at the last)."""
    from recursive_stwo_tpu_torch.ops import launches, poseidon_cuda
    from recursive_stwo_tpu_torch.prover import channel

    def timed(fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    k1_launches = None
    for bits in GRIND_BITS:
        digest = np.random.default_rng(SEED + bits).integers(0, P, 8).astype(np.uint32)
        launches.reset()
        nonce, kernel_s = timed(lambda: poseidon_cuda.p31_grind(digest, bits, device=dev))
        got = launches.counts()
        require((got["p31_grind"], got["permute_rows"]) == (1, 0), f"p31_grind: not one launch and no K1: {got}")
        launches.reset()
        plain, plain_s = timed(lambda: channel.grind_device(digest, bits, device=dev))
        k1_launches = k1_launches or launches.counts()
        require(launches.counts()["permute_rows"] > 0, f"grind_device never launched permute_rows: {launches.counts()}")
        host, host_s = timed(lambda: channel.grind_host(digest, bits))
        require(nonce == plain == host, f"p31_grind found {nonce} at {bits} bits, grind_device {plain}, "
                                        f"the host scan {host}")
        print(f"p31 grind at {bits} bits: nonce {nonce}; the kernel {kernel_s:.4f} s (one launch and its read), "
              f"grind_device {plain_s:.3f} s ({launches.counts()['permute_rows']} K1 blocks of 2**22), "
              f"host native scan {host_s:.3f} s")
    out = dict(timed_kernel(torch, "p31_grind", f"{bits} bits, nonce {nonce}",
                            lambda: poseidon_cuda.p31_grind(digest, bits, device=dev),
                            lambda: channel.grind_device(digest, bits, device=dev), "poseidon2_grind_kernel", 1,
                            (poseidon_cuda.grind_bound_ms(nonce + 1), "operations"), 5),
               nonce=nonce, host_ms=host_s * 1e3, max_abs_err=0, library_ms=None)
    return k1_launches, out


def check_sha_grind(torch, dev) -> dict:
    """Phase 9: the SHA-256 grind kernel against the native host scan at
    SHA_GRIND_BITS on seeded digests (seed SEED + bits) and from just below
    2**32, one launch a grind; its times at the 28-bit grind beside
    grind_bound_ms of the nonces up to the hit (the kernel scans a little
    more: the chunks in flight).  Returns {nonce, ms, events_ms, plain_ms,
    bound_ms, bound_by, max_abs_err, library_ms} at 28 bits."""
    from recursive_stwo_tpu_torch.ops import sha256_cuda
    from recursive_stwo_tpu_torch.utils import native

    def digest(seed):
        return np.random.default_rng(seed).integers(0, 2**32, 8, dtype=np.uint64).astype(np.uint32)

    cases = [(bits, SEED + bits, 0) for bits in SHA_GRIND_BITS] + [(16, SEED, 2**32 - 4096)]
    found = {}
    for bits, seed, start in cases:
        before = sha256_cuda.LAUNCHES["sha256_grind"]
        nonce = sha256_cuda.sha256_grind(digest(seed), bits, start, device=dev)
        require(sha256_cuda.LAUNCHES["sha256_grind"] == before + 1, "sha256_grind: not one launch a grind")
        host = native.sha256_grind(digest(seed), bits, start)
        require(nonce == host, f"sha256_grind found {nonce} at {bits} bits from {start}, the host scan {host}")
        found[(bits, start)] = nonce
    require(found[(16, 2**32 - 4096)] >= 2**32, "sha256_grind: the case from below 2**32 did not cross it")
    print(f"sha256_grind: the native scan's nonce at (bits, start) {sorted(found)}: {sorted(found.values())}")
    bits = SHA_GRIND_BITS[-1]
    d, nonce = digest(SEED + bits), found[(bits, 0)]
    out = dict(timed_kernel(torch, "sha256_grind", f"{bits} bits, nonce {nonce}",
                            lambda: sha256_cuda.sha256_grind(d, bits, device=dev),
                            lambda: native.sha256_grind(d, bits), "sha256_grind_kernel", 1,
                            (sha256_cuda.grind_bound_ms(nonce + 1), "operations"), 5),
               nonce=nonce, max_abs_err=0, library_ms=None)
    return out


def np_rate(torch, dev) -> float:
    """Phase 10: np_flavor_proofs_per_sec, warm proofs/s of verify_batch_np
    on np_small at B=NP_BATCH."""
    from recursive_stwo_tpu_torch.models import flagship

    step, arrays = flagship.verifier_step_np("np_small", NP_BATCH, device=dev)
    return _median_rate(torch, "np_small verify_batch_np", step, arrays, NP_BATCH)


def _mean_ms(fn, runs: int = 3) -> float:
    t = time.perf_counter()
    for _ in range(runs):
        fn()
    return (time.perf_counter() - t) / runs * 1e3


def _bench_rate(torch, step, arrays, fs, batch: int, reps: int = 5) -> float:
    """bench.py's _time (bench.py:64-70): one warm call, then `reps` calls
    back to back and one synchronize(); proofs/s over their mean."""
    step(arrays, fs)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        step(arrays, fs)
    torch.cuda.synchronize()
    return batch / ((time.perf_counter() - t) / reps)


def check_sha(torch, dev) -> dict:
    """Phase 11: the SHA-256 flavours.  Returns bench.py's SHA metrics."""
    import copy

    from recursive_stwo_tpu_torch.models import flagship
    from recursive_stwo_tpu_torch.ops import launches as kernel_launches
    from recursive_stwo_tpu_torch.utils import native
    from recursive_stwo_tpu_torch.verifier import verify_sha256 as vs
    from recursive_stwo_tpu_torch.verifier import verify_sha256_host as vh

    require(native.sha_available(), "the native SHA-256 library is not available")
    print("native SHA-256 library: available (the host path timed is the native one)")

    def once(label, fn, folds=0):
        """fn(), which must launch the composition check kernel exactly
        once and the fold kernel `folds` times."""
        torch.cuda.synchronize()
        kernel_launches.reset()
        out = fn()
        torch.cuda.synchronize()
        got = kernel_launches.counts()
        require(got["composition_check"] == 1 and got["fold_phase"] == folds,
                f"{label}: expected 1 composition_check and {folds} fold_phase launches, got {got}")
        return out

    level14, bitcoin = flagship.sha_artifacts()
    inner = flagship.CHAIN_INPUTS
    t = time.perf_counter()
    btc_inputs = flagship.bitcoin_inputs()
    print(f"bitcoin public inputs: {len(btc_inputs)}, from the last-layer circuit over level 14 "
          f"in {time.perf_counter() - t:.2f} s")

    require(vh.verify_sha256p31_host(level14, inner)["ok"].all(), "level 14 rejected on the host")
    require(vh.verify_sha256np_host(bitcoin, btc_inputs)["ok"].all(), "bitcoin proof rejected on the host")
    require(once("level 14 fast path", lambda: vs.verify_sha256p31(level14, inner, device=dev))["ok"].all(),
            "level 14 rejected (fast path)")
    require(once("bitcoin fast path", lambda: vs.verify_sha256np(bitcoin, btc_inputs, device=dev))["ok"].all(),
            "bitcoin proof rejected (fast path)")

    # the corruptions of tests/test_sha256_device.py:64-100
    bad = copy.deepcopy(level14)
    col = bad.stark_proof.sampled_values[2][0]
    col[0] = tuple((int(x) + 1) % P for x in col[0])
    r = vs.verify_sha256p31(bad, inner, device=dev)
    require(not r["ok"].any() and not r["merkle_fri"].any(), f"level 14, corrupted sampled value: {r}")
    bad = copy.deepcopy(bitcoin)
    fw = np.asarray(bad.stark_proof.fri_proof.first_layer.fri_witness, np.uint32).copy()
    fw.flat[0] = (int(fw.flat[0]) + 1) % P
    bad.stark_proof.fri_proof.first_layer.fri_witness = fw
    r = vs.verify_sha256np(bad, btc_inputs, device=dev)
    require(not r["ok"].any() and not r["merkle_fri"].any(), f"bitcoin, corrupted FRI witness: {r}")
    wrong = list(btc_inputs)
    idx, val = wrong[5]
    wrong[5] = (idx, ((val[0] + 1) % P,) + val[1:])
    r = once("bitcoin fast path, wrong public input", lambda: vs.verify_sha256np(bitcoin, tuple(wrong), device=dev))
    require(not r["ok"].any() and _failing(r, 0) == ["ok", "total_sum"], f"bitcoin, wrong public input: {r}")
    print("fast paths on CUDA: level 14 and bitcoin accepted; corrupted sampled value -> merkle_fri, "
          "corrupted FRI witness -> merkle_fri, wrong public input -> total_sum; the composition check kernel "
          "launched once in each accepting call, the fold kernel in none")

    def corrupted_checks(kind, device):
        step, arrays, fs = flagship.sha_checks_step(kind, SHA_BATCH, device=device)
        arrays.samples_flat[SAMPLE_SLOT, 0, 0] ^= 1
        fs.pow_digest0[NONCE_SLOT] ^= 1
        return step(arrays, fs)

    metrics = {}
    for kind in ("level14", "bitcoin"):
        got = once(f"{kind} device checks", lambda: corrupted_checks(kind, dev), folds=1)
        ref = corrupted_checks(kind, "cpu")
        require(list(got) == list(ref), f"{kind}: device check names differ from the CPU run")
        for k in ref:
            require(torch.equal(got[k].cpu(), ref[k]), f"{kind}: device check {k} differs from the CPU run")
        ok = got["ok"].cpu().numpy()
        clean = np.ones(SHA_BATCH, bool)
        clean[[SAMPLE_SLOT, NONCE_SLOT]] = False
        require(ok[clean].all() and not ok[SAMPLE_SLOT], f"{kind}: device checks {_failing(got, SAMPLE_SLOT)}")
        require(_failing(got, NONCE_SLOT) == ["ok", "pow"], f"{kind}: pow flip fails {_failing(got, NONCE_SLOT)}")
        print(f"{kind} device checks B={SHA_BATCH}: all {len(ref)} checks equal the CPU run per slot; "
              f"sampled-value slot fails {_failing(got, SAMPLE_SLOT)}, pow slot fails ['ok', 'pow']")
        step, arrays, fs = flagship.sha_checks_step(kind, SHA_BATCH, device=dev)
        name = "sha256p31_device_proofs_per_sec" if kind == "level14" else "bitcoin_device_proofs_per_sec"
        metrics[name] = _bench_rate(torch, step, arrays, fs, SHA_BATCH)

    metrics["bitcoin_np_host_verify_ms"] = _mean_ms(lambda: vh.verify_sha256np_host(bitcoin, btc_inputs))
    metrics["sha256p31_host_verify_ms"] = _mean_ms(lambda: vh.verify_sha256p31_host(level14, inner))
    for fast, args, key in ((vs.verify_sha256p31, (level14, inner), "sha256p31_verify_ms"),
                            (vs.verify_sha256np, (bitcoin, btc_inputs), "bitcoin_fast_path_ms")):
        for device, suffix in ((dev, ""), ("cpu", "_cpu")):
            trials = []
            for _ in range(3):
                t = time.perf_counter()
                fast(*args, device=device)
                trials.append((time.perf_counter() - t) * 1e3)
            metrics[key + suffix] = min(trials)
    return metrics


def mesh_rank(device) -> dict:
    """Phase 14 (c) and (d), inside each of MESH_RANKS gloo ranks on the card.
    (c): phase 4's corrupted batch through verify_sharded, with the kernels'
    launches counted around it; (d): the clean batch's shares timed over
    MESH_SIZES ranks (tools/mesh_times.time_shares).  Returns the gathered
    checks, the launches and the timings."""
    import torch

    from recursive_stwo_tpu_torch.models import flagship
    from recursive_stwo_tpu_torch.ops import launches as kernel_launches
    from recursive_stwo_tpu_torch.parallel import mesh as pmesh
    from recursive_stwo_tpu_torch.tools.mesh_times import time_shares

    t = time.perf_counter()
    name = FIXTURES[0]
    spec, pa1 = flagship.prepared_arrays(name)
    inputs = flagship.FIXTURE_INPUTS[name]
    pa = _corrupted(flagship.tiled_batch(pa1, BATCH))
    torch.cuda.synchronize()
    kernel_launches.reset()
    *_, named = pmesh.verify_sharded(spec, pa, inputs, pmesh.make_mesh(device), checks=True)
    launches = kernel_launches.counts()
    seconds = [time.perf_counter() - t]
    t = time.perf_counter()
    timing = time_shares(device, spec, flagship.tiled_batch(pa1, BATCH), inputs, MESH_SIZES, MESH_RUNS)
    seconds.append(time.perf_counter() - t)
    return dict(named={k: v.numpy() for k, v in named.items()}, launches=launches, timing=timing, seconds=seconds)


def check_mesh(torch, smi: str, host_checks: dict) -> list:
    """Phase 14.  `host_checks` are phase 4's CPU checks.  Returns each
    rank's launches in (c)."""
    from recursive_stwo_tpu_torch.parallel import launch
    from recursive_stwo_tpu_torch.parallel.dryrun import dryrun_multichip
    from recursive_stwo_tpu_torch.tools.mesh_times import summary

    from concurrent.futures import ThreadPoolExecutor

    def dry_run(n, backend):
        t = time.perf_counter()
        return dryrun_multichip(n, backend=backend, devices=("cuda:0",) * n, timeout=MESH_TIMEOUT), \
            time.perf_counter() - t

    start = time.perf_counter()
    torch.cuda.empty_cache()  # the ranks' contexts share the card with this process
    dry_runs = ((1, "nccl"), (MESH_RANKS, "gloo"))
    with ThreadPoolExecutor(len(dry_runs)) as pool:  # (a) and (b) at once: each waits mostly on its ranks' start
        futures = [pool.submit(dry_run, n, backend) for n, backend in dry_runs]
    for (n, backend), future in zip(dry_runs, futures):
        results, wall = future.result()
        for rank, r in enumerate(results):
            got = r["launches"]
            require(got["transcript"] > 0 and got["permute_rows"] == 0 and got["wordmajor_scan"] > 0
                    and got["permute_wordmajor"] > 0 and got["sha256_level"] == 0 and got["composition_check"] > 0
                    and got["composition_domain"] == 0 and got["fold_phase"] > 0,
                    f"dry run, {backend} rank {rank}: {got}")
        print(f"dry run on {n} {backend} rank(s) on cuda:0: every case passed in {wall:.1f} s "
              f"({', '.join(results[0]['verdicts'])}); fault per host "
              f"{results[0]['verdicts'].get('fault per-host', np.array([])).tolist()}; launches per rank "
              f"{[r['launches'] for r in results]}")

    t = time.perf_counter()
    ranks = launch.spawn(mesh_rank, MESH_RANKS, "gloo", ("cuda:0",), timeout=MESH_TIMEOUT)
    for rank, r in enumerate(ranks):
        named = r["named"]
        require(list(named) == list(host_checks), f"mesh rank {rank}: check names differ from phase 4's CPU run")
        for k, v in host_checks.items():
            require(np.array_equal(named[k], v.numpy()), f"mesh rank {rank}: check {k} differs from phase 4's CPU run")
        got = r["launches"]
        require(got["transcript"] == 1 and got["permute_rows"] == 0 and got["wordmajor_scan"] == 2
                and got["permute_wordmajor"] == 1 and got["composition_check"] == 1 and got["fold_phase"] == 1,
                f"mesh rank {rank}: launches {got}, expected 1 transcript launch and no K1, 2 scans, 1 K2 step, "
                f"1 composition check, 1 fold")
    print(f"{FIXTURES[0]} B={BATCH} over {MESH_RANKS} gloo ranks on cuda:0 (verify_sharded): all "
          f"{len(host_checks)} checks equal phase 4's CPU run per slot; launches per rank "
          f"{[r['launches'] for r in ranks]} ({time.perf_counter() - t:.1f} s with phase (d); in the slowest rank "
          f"{max(r['seconds'][0] for r in ranks):.1f} s for (c), {max(r['seconds'][1] for r in ranks):.1f} s for (d))")
    for row in summary([r["timing"] for r in ranks], ["cuda:0"] * MESH_RANKS, BATCH):
        print(f"{FIXTURES[0]} B={BATCH} over {row['ranks']} rank(s) sharing the card: {row['proofs_per_s']:.1f} "
              f"proofs/s (the slowest rank's wall, median {row['wall_ms_median']:.1f} ms of "
              f"{', '.join(f'{w:.1f}' for w in row['wall_ms'])}); kernels a rank {row['kernels']}, copies and "
              f"fills a rank {row['copies_and_fills']}; kernels {row['kernel_ms']['cuda:0']:.1f} ms "
              f"summed over the ranks = card busy {row['busy_share']['cuda:0']:.1%}; on {smi}")
    print(f"phase 14: {time.perf_counter() - start:.1f} s")
    return [r["launches"] for r in ranks]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs a GPU", file=sys.stderr)
        return 1
    start = clock = time.perf_counter()
    dev = torch.device("cuda")
    smi = card_line()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    def phase_done(label: str) -> None:
        nonlocal clock
        now = time.perf_counter()
        print(f"phase {label}: {now - clock:.1f} s")
        clock = now

    from recursive_stwo_tpu_torch.models import flagship
    from recursive_stwo_tpu_torch.ops import build, latency_cuda

    t = time.perf_counter()
    lib_path = build.library_path()
    build.load()
    print(f"build: {time.perf_counter() - t:.2f} s -> {lib_path}")
    with open(lib_path + ".log") as f:
        print(f.read().strip())
    for name in ("transcript_kernel", "composition_check_kernel", "composition_domain_kernel", "fold_kernel",
                 "fft_pass_kernel", "fft_tile_twiddle_kernel", "quotient_coeffs_kernel", "quotient_points_kernel",
                 "sample_kernel", "sample_finish_kernel", "interaction_kernel", "fri_layer_kernel",
                 "fri_last_kernel", "merkle_level_kernel", "sha256_grind_kernel", "poseidon2_grind_kernel"):
        for r in build.ptxas_report(name):
            print(f"ptxas {name} ({r['kernel']}): {r['registers']} registers, {r['smem_bytes']} bytes static smem, "
                  f"{r['stack_bytes']} bytes stack frame, "
                  f"{r['spill_stores']} bytes spill stores, {r['spill_loads']} bytes spill loads")
    for name in ("composition_domain_kernel", "interaction_kernel", "sample_kernel"):
        for r in build.sass_instructions(name):
            print(f"sass {name} ({r['kernel']}): {r['instructions']} instructions")
    phase_done("1-2 (card, build)")

    from recursive_stwo_tpu_torch.tools.scan_cases import fixture_programs

    programs, leaf_state = {}, None
    for name in FIXTURES:
        programs[name], leaves = fixture_programs(name, BATCH, dev)
        leaf_state = leaves if leaf_state is None else leaf_state
    programs["np_small"], np_leaf_state = fixture_programs("np_small", NP_BATCH, dev)
    kernels = check_kernels(torch, dev, leaf_state, np_leaf_state)
    scans = check_scan(torch, dev, programs)
    kernels["wordmajor_scan"] = scans[FIXTURES[0]]
    kernels["wordmajor_scan"].update(
        np_shape=[list(p.ops.shape[:2]) + [p.n] for _, p in programs["np_small"]],
        **{f"np_{k}": scans["np_small"][k] for k in ("ms", "plain_ms", "bound_ms")},
    )
    del programs, leaf_state, np_leaf_state
    kernels["sha256_level"] = check_sha_kernel(torch, dev)
    lat = latency_cuda.step_latencies(dev)
    print(f"latency probe, cycles a dependent step: {', '.join(f'{k} {lat[k]:.2f}' for k in latency_cuda.KINDS)}; "
          f"SM clock {lat['ghz']:.3f} GHz")
    kernels["composition_check"], kernels["composition_domain"] = check_composition_kernels(torch, dev, lat)
    kernels["fold_phase"] = check_fold_kernel(torch, dev)
    kernels["transcript"] = check_transcript_kernel(torch, dev, lat)
    kernels["circle_fft"], kernels["eval_tiles"], kernels["quotients"] = check_prover_kernels(torch, dev)
    kernels["sample"], kernels["interaction"] = check_sample_interaction(torch, dev)
    kernels["fri_fold"], kernels["merkle_level"] = check_fri_merkle(torch, dev)
    kernels["fri_last"] = check_fri_last(torch, dev)
    torch.cuda.synchronize()
    phase_done("3 (kernels vs plain)")

    launches, host_checks = {}, {}
    for name in FIXTURES:
        launches[name], host_checks[name] = check_main_path(torch, dev, name)
        torch.cuda.synchronize()
    phase_done("4-5 (verify_batch vs CPU)")

    for name in FIXTURES:
        rate = proofs_per_s(torch, dev, name)
        walls = phase_ms(torch, dev, name)
        print(f"{name}: {rate:.1f} proofs/s ({BATCH / rate * 1e3:.1f} ms a batch), transcript "
              f"{walls['transcript']:.2f} ms, fold phase {walls['fold phase']:.2f} ms, hash phase {walls['hash phase']:.2f} ms, composition "
              f"{walls['composition']:.2f} ms a batch, at B={BATCH} on {smi}")
    phase_done("6 (timing)")

    check_demo_proof(torch, dev)
    seen = set()  # shapes proved so far (tools/chain.run_level's `cold`)
    levels = {level: prove_level(dev, level, seen) for level in (1, 2, 3)}
    phase_done("7-8 (chain levels 1-3)")
    grind_launches, kernels["p31_grind"] = check_grind(torch, dev)
    kernels["sha256_grind"] = check_sha_grind(torch, dev)
    phase_done("9 (grinds)")

    np_launches, _ = check_np_path(torch, dev)
    torch.cuda.synchronize()
    np_rate_v = np_rate(torch, dev)
    print(f"np_small: np_flavor_proofs_per_sec {np_rate_v:.1f} at B={NP_BATCH} on {smi}")
    phase_done("10 (without-Poseidon)")
    sha = check_sha(torch, dev)
    print(f"bitcoin_np_host_verify_ms {sha['bitcoin_np_host_verify_ms']:.2f} (mean of 3, host); "
          f"bitcoin_device_proofs_per_sec {sha['bitcoin_device_proofs_per_sec']:.1f} at B={SHA_BATCH}; "
          f"sha256p31_host_verify_ms {sha['sha256p31_host_verify_ms']:.2f} (mean of 3, host); "
          f"sha256p31_verify_ms {sha['sha256p31_verify_ms']:.2f} with the composition on CUDA, "
          f"{sha['sha256p31_verify_ms_cpu']:.2f} on the CPU (min of 3); on {smi}")
    print(f"bitcoin fast path (verify_sha256np, timed as bench.py times sha256p31_verify_ms; not one of its "
          f"metrics) {sha['bitcoin_fast_path_ms']:.2f} ms on CUDA, {sha['bitcoin_fast_path_ms_cpu']:.2f} on the CPU "
          f"(min of 3)")
    print(f"sha256p31_device_proofs_per_sec {sha['sha256p31_device_proofs_per_sec']:.1f} at B={SHA_BATCH} "
          f"(new, not one of bench.py's metrics: device_checks_p31 on level 14, timed as bench.py times "
          f"bitcoin_device_proofs_per_sec)")
    phase_done("11 (SHA-256 flavours)")
    levels[LAST_LAYER] = prove_level(dev, LAST_LAYER, seen, flagship.sha_artifact("level14"))
    phase_done("12 (last layer)")
    check_demo_sha_proof(dev)
    phase_done("13 (demo prove_sha256p31)")
    mesh_launches = check_mesh(torch, smi, host_checks[FIXTURES[0]])
    phase_done("14 (multi-device)")
    streamed = check_streamed(torch, dev, seen, levels)
    phase_done("15 (streamed provers)")

    require("jax" not in sys.modules, "jax was imported")
    require(not any(m.split(".")[0] == "recursive_stwo_tpu" for m in sys.modules), "the JAX package was imported")
    replaces = {
        "permute_rows": "recursive_stwo_tpu/ops/poseidon_pallas.py:46",
        "permute_wordmajor": "recursive_stwo_tpu/ops/poseidon_pallas.py:182",
        "wordmajor_scan": "recursive_stwo_tpu/ops/poseidon_pallas.py:182 and the scans at "
                          "recursive_stwo_tpu/verifier/hashplan.py:206,427",
        "sha256_level": "recursive_stwo_tpu/core/sha256.py:85 (_compress_traced), reached from "
                        "recursive_stwo_tpu/prover/stream.py:278-298",
        "composition_check": "recursive_stwo_tpu/verifier/composition.py:533 (composition_check, with the "
                             "lax.scans at :437 and :529; composition_check_np :280)",
        "composition_domain": "recursive_stwo_tpu/prover/device_prove.py:417 (_stage_composition_jit, "
                              "_ProverEval :202)",
        "fold_phase": "recursive_stwo_tpu/verifier/verify.py:97 (fold_phase, with the lax.scans at "
                      "recursive_stwo_tpu/verifier/points.py:119,155, quotients.py:105, fri.py:139 and "
                      "core/m31.py:195)",
        "transcript": "recursive_stwo_tpu/verifier/transcript.py:97 (digest_chain, the lax.scan at :121) and :159 "
                      "(the batched draw)",
        "circle_fft": "recursive_stwo_tpu/prover/circle_fft.py:156,174,193 (interpolate_traced, evaluate_traced, "
                      "extend_traced), reached through prover/device_prove.py:149 (_lde_t)",
        "eval_tiles": "recursive_stwo_tpu/prover/stream.py:164,176 (_tile_twiddles, _eval_tiles)",
        "quotients": "recursive_stwo_tpu/prover/device_prove.py:543 (_stage_quotients_jit) and "
                     "recursive_stwo_tpu/prover/stream.py:585 (_quot_chunk_jit)",
        "sample": "recursive_stwo_tpu/prover/device.py:244 (_sample_jit), called at "
                  "recursive_stwo_tpu/prover/device_prove.py:789-804",
        "interaction": "recursive_stwo_tpu/prover/device_prove.py:342 (_interaction_traced, _InteractionEval :277), "
                       "jitted by _interaction_cols_jit :373 and _stage_interaction_jit :390",
        "fri_fold": "recursive_stwo_tpu/prover/device_prove.py:572 (_fold_line_jit) and :593 (_join_commit_jit's "
                    "fold), recursive_stwo_tpu/prover/stream.py:667 (_join_fold_jit) and :704 (_line_fold_jit)",
        "merkle_level": "recursive_stwo_tpu/prover/device_prove.py:49 (_absorb_columns) and :66 (_commit_levels), "
                        "recursive_stwo_tpu/prover/stream.py:252 (_commit_chunk_jit, p31)",
        "sha256_grind": "no TPU kernel: the host scan of recursive_stwo_tpu/prover/prove_sha256.py (grind_pow), "
                        "on native/sha256.cpp's AVX-512 sha256_grind",
        "p31_grind": "no TPU kernel: the fused form of recursive_stwo_tpu/prover/channel.py:20-70 "
                     "(_grind_batch_jit, grind_device: K1 on 2**22 states a block), and of the host scan "
                     "native/poseidon31.cpp poseidon2_grind below 22 bits",
        "fri_last": "no TPU kernel: the host numpy recursive_stwo_tpu/prover/fri.py:84 (line_interpolate) after a "
                    "copy of the folded layer, called at recursive_stwo_tpu/prover/device_prove.py:913, "
                    "prove.py:443 and stream.py:1157",
    }
    sources = {k: "recursive_stwo_tpu_torch/csrc/poseidon2.cu" for k in replaces}
    sources["sha256_level"] = "recursive_stwo_tpu_torch/csrc/sha256.cu"
    sources["composition_check"] = sources["composition_domain"] = "recursive_stwo_tpu_torch/csrc/composition.cu"
    sources["fold_phase"] = "recursive_stwo_tpu_torch/csrc/fold.cu"
    sources["transcript"] = "recursive_stwo_tpu_torch/csrc/transcript.cu"
    sources["circle_fft"] = sources["eval_tiles"] = "recursive_stwo_tpu_torch/csrc/circle_fft.cu"
    sources["quotients"] = "recursive_stwo_tpu_torch/csrc/quotients.cu"
    sources["sample"] = "recursive_stwo_tpu_torch/csrc/sample.cu"
    sources["interaction"] = "recursive_stwo_tpu_torch/csrc/interaction.cu"
    sources["fri_fold"] = "recursive_stwo_tpu_torch/csrc/fri_fold.cu"
    sources["merkle_level"] = "recursive_stwo_tpu_torch/csrc/merkle.cu"
    sources["fri_last"] = "recursive_stwo_tpu_torch/csrc/fri_fold.cu"
    sources["sha256_grind"] = "recursive_stwo_tpu_torch/csrc/sha256_grind.cu"
    sources["p31_grind"] = "recursive_stwo_tpu_torch/csrc/poseidon2_grind.cu"
    # the main path of each: phase 4's verify_batch for the transcript, K2,
    # scan, check and fold kernels, phase 15 (c)'s streamed last layer for
    # the SHA-256, SHA-256 grind and tile kernels, phase 9's grind_device for K1, phase 7's
    # level-1 proof for the Poseidon31 grind, the domain kernel, the circle
    # FFT, the quotients, the sampling, the interaction, the fold-layer, the
    # last-layer and the Merkle level kernels
    main_launches = {k: launches[FIXTURES[0]][k] for k in replaces}
    for k in ("sha256_level", "eval_tiles", "sha256_grind"):
        main_launches[k] = streamed[LAST_LAYER][k]
    main_launches["permute_rows"] = grind_launches["permute_rows"]
    for k in ("p31_grind", "composition_domain", "circle_fft", "quotients", "sample", "interaction", "fri_fold",
              "fri_last", "merkle_level"):
        main_launches[k] = levels[1]["prove_launches"][k]
    report = [
        dict(name=k, route="cuda", source=sources[k],
             replaces=replaces[k], launches=main_launches[k],
             prover_launches=levels[1]["prove_launches"][k], level2_launches=levels[2]["prove_launches"][k],
             level3_launches=levels[3]["prove_launches"][k],
             last_layer_launches=levels[LAST_LAYER]["prove_launches"][k],
             streamed_launches={"level3": streamed[3][k], "last_layer": streamed[LAST_LAYER][k]},
             np_launches=np_launches[k], mesh_launches=[r[k] for r in mesh_launches], **kernels[k])
        for k in replaces
    ]
    print(f"chip_smoke: all phases passed in {time.perf_counter() - start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)
