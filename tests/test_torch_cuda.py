"""The port's CUDA kernels on the card: each against its plain PyTorch
version and the reference's numpy permutation, bit for bit, plus the
verifier's main path on CUDA against the host reference.  Marked `cuda`;
each test skips when no CUDA device is present.  On a GPU machine:

    python -m pytest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from recursive_stwo_tpu.core import poseidon2 as r_p2
from recursive_stwo_tpu.verifier import verify as r_verify
from recursive_stwo_tpu_torch.core import poseidon2 as t_p2
from recursive_stwo_tpu_torch.models import flagship
from recursive_stwo_tpu_torch.ops import launches, poseidon_cuda
from recursive_stwo_tpu_torch.tools import scan_cases
from recursive_stwo_tpu_torch.verifier import hashplan
from recursive_stwo_tpu_torch.verifier import verify as t_verify
from recursive_stwo_tpu_torch.verifier.arrays import to_torch

pytestmark = pytest.mark.cuda
P = 2**31 - 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _verifier_launches(got: dict) -> None:
    """One verifier call's launches: the transcript kernel once and K1
    never, the hash phase's two scans and one K2 leaf step, the check and
    fold kernels once each."""
    assert (got["transcript"], got["permute_rows"]) == (1, 0), got
    assert (got["wordmajor_scan"], got["permute_wordmajor"]) == (2, 1), got
    assert (got["composition_check"], got["fold_phase"], got["composition_domain"], got["sha256_level"],
            got["sha256_grind"]) == (1, 1, 0, 0, 0), got


def _states(seed, n):
    x = np.random.default_rng(seed).integers(0, P, (n, 16), dtype=np.int64)
    x[:2] = np.stack([np.arange(16), np.full(16, P - 1)])[: min(n, 2)]
    return x


@pytest.mark.parametrize("n", [1, 127, 1000, 4097])
def test_permute_rows_bit_exact(cuda, n):
    x = _states(n, n)
    xd = torch.from_numpy(x).to(cuda)
    before = poseidon_cuda.LAUNCHES["permute_rows"]
    got = poseidon_cuda.permute_rows(xd)
    torch.cuda.synchronize()
    assert poseidon_cuda.LAUNCHES["permute_rows"] == before + 1
    assert torch.equal(got, t_p2.permute_plain(xd))
    assert np.array_equal(got.cpu().numpy(), r_p2.permute(x.astype(np.uint32)).astype(np.int64))


KAT = [  # Poseidon2-16 of the state (0, 1, ..., 15)
    260776483, 1182896747, 1656699352, 746018898, 102875940, 1812541025,
    515874083, 755063943, 1682438524, 1265420601, 238640995, 200799880,
    1659717477, 2080202267, 1269806256, 1287849264,
]


@pytest.mark.parametrize("schedule", poseidon_cuda.ROWS_SCHEDULES)
@pytest.mark.parametrize("n", [1, 7, 8, 1023, 1024, (1 << 20) + 3, 1 << 23])
def test_permute_rows_schedule_bit_exact(cuda, schedule, n):
    """Each K1 schedule against the plain version, tails included (a quad
    of lanes per row: 8 rows a warp, 32 a block), and the KAT in row 0."""
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randint(0, P, (n, 16), generator=gen, device=cuda, dtype=torch.int64)
    x[-1] = P - 1
    x[0] = torch.arange(16, device=cuda)
    got = poseidon_cuda.permute_rows_schedule(x, schedule)
    torch.cuda.synchronize()
    assert torch.equal(got, t_p2.permute_plain(x))
    assert got[0].tolist() == KAT


def test_permute_rows_rejects_misaligned(cuda):
    x = torch.zeros(17 * 16, dtype=torch.int64, device=cuda)[1 : 1 + 16 * 16].view(16, 16)
    with pytest.raises(ValueError, match="aligned"):
        poseidon_cuda.permute_rows(x)
    # core/poseidon2.permute copies such a view first
    assert torch.equal(t_p2.permute(x), t_p2.permute_plain(x))


@pytest.mark.parametrize("lanes,n", [(1, 5), (4, 1000), (3, 4096)])
def test_permute_wordmajor_bit_exact(cuda, lanes, n):
    x = _states(lanes * n, lanes * n).reshape(lanes, n, 16)
    wm = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))).to(cuda)
    got = poseidon_cuda.permute_wordmajor(wm)
    torch.cuda.synchronize()
    assert torch.equal(got, t_p2.permute_wordmajor_plain(wm))
    ref = r_p2.permute(x.astype(np.uint32)).astype(np.int64)
    assert np.array_equal(np.moveaxis(got.cpu().numpy(), 1, -1), ref)


@pytest.mark.parametrize("n,lanes", [(1, 1), (7, 2), (127, 3), (129, 4), (16384, 4)])
def test_wordmajor_scan_bit_exact(cuda, n, lanes):
    """The scan kernel against scan_plain on the seeded absorb and walk
    programs (every op kind; 1, 7, 127 and 129 slots leave tails of a warp
    and of a block)."""
    for label, prog in scan_cases.seeded_programs(n, lanes, n, cuda):
        want = hashplan.scan_plain(prog)
        got = poseidon_cuda.wordmajor_scan(prog.ops, prog.sources, prog.n_out, prog.n, prog.keep_capacity)
        torch.cuda.synchronize()
        assert torch.equal(got, want), label


def test_verify_batch_launches_two_scans_and_one_leaf_step(cuda, monkeypatch):
    """One verify_batch on CUDA: the absorb and the walk pass are one scan
    launch each, the leaves one K2 step, and scan_plain never runs."""
    def refuse(prog):
        raise AssertionError("scan_plain ran on the CUDA path")

    monkeypatch.setattr(hashplan, "scan_plain", refuse)
    step, arrays = flagship.verifier_step("small_proof", 8, device=cuda)
    poseidon_cuda.reset_launches()
    ok = step(arrays)["ok"]
    torch.cuda.synchronize()
    assert bool(ok.all())
    assert poseidon_cuda.LAUNCHES["wordmajor_scan"] == 2
    assert poseidon_cuda.LAUNCHES["permute_wordmajor"] == 1


def test_verify_batch_on_cuda_matches_host_reference(cuda):
    spec, pa1 = flagship.prepared_arrays("small_proof")
    pa = flagship.tiled_batch(pa1, 4)
    pa.tree_paths[1].sibling_hashes[2, 0, 0, 0] ^= np.uint32(1)
    ref = r_verify.verify_batch(spec, pa)
    launches.reset()
    got = t_verify.verify_batch(spec, to_torch(pa, cuda))
    torch.cuda.synchronize()
    _verifier_launches(launches.counts())
    assert list(ref) == list(got)
    for k in ref:
        assert np.array_equal(np.asarray(ref[k]), got[k].cpu().numpy()), k
    assert sorted(k for k, v in got.items() if not v[2]) == ["ok", "tree1"]


def test_prove_on_cuda_matches_host(cuda, monkeypatch):
    from recursive_stwo_tpu.prover.prove import prove as r_prove
    from recursive_stwo_tpu_torch.prover.prove import prove as t_prove

    trace = flagship.demo_trace()
    launches.reset()
    got = t_prove(trace, flagship.DEMO_CONFIG, device=cuda)
    torch.cuda.synchronize()
    counts = launches.counts()
    # the Merkle level kernel commits the trees; the demo's PoW is the host's
    assert counts["merkle_level"] > 0 and counts["permute_rows"] == 0, counts
    # the JAX package's host flow (its device flow would take jax to the GPU)
    monkeypatch.setenv("RSTPU_DEVICE_PROVER", "0")
    assert flagship.proof_bytes(got) == flagship.proof_bytes(r_prove(trace, flagship.DEMO_CONFIG))


@pytest.mark.parametrize("pow_bits", [12, 22])
def test_grind_device_on_cuda_matches_native_scan(cuda, pow_bits):
    from recursive_stwo_tpu.utils import native
    from recursive_stwo_tpu_torch.prover.channel import grind_device

    digest = np.random.default_rng(pow_bits).integers(0, P, 8).astype(np.uint32)
    assert grind_device(digest, pow_bits, device=cuda) == native.grind(digest, pow_bits)


# (pow_bits, start): seeded digests (seed pow_bits, or 1000 with a start) whose
# smallest nonces are 108, 2,545, 23,458, 117,125 and 20,994,700, the last
# three past the first chunk of 2**13 nonces, and 2**32 + 119,627 from 4,096
# below 2**32, where the scan crosses the high word's carry
SHA_GRINDS = {"8": (8, 0), "12": (12, 0), "16": (16, 0), "20": (20, 0), "24": (24, 0),
              "across 2**32": (16, 2**32 - 4096)}


@pytest.mark.parametrize("case", list(SHA_GRINDS))
def test_sha256_grind_matches_native_scan(cuda, case):
    """The SHA-256 grind kernel returns the native host scan's nonce, in one
    launch, from any start."""
    from recursive_stwo_tpu_torch.ops import sha256_cuda
    from recursive_stwo_tpu_torch.utils import native

    pow_bits, start = SHA_GRINDS[case]
    digest = np.random.default_rng(1000 if start else pow_bits).integers(0, 2**32, 8, dtype=np.uint64)
    digest = digest.astype(np.uint32)
    before = sha256_cuda.LAUNCHES["sha256_grind"]
    nonce = sha256_cuda.sha256_grind(digest, pow_bits, start, device=cuda)
    assert sha256_cuda.LAUNCHES["sha256_grind"] == before + 1
    assert nonce == native.sha256_grind(digest, pow_bits, start)
    assert nonce >= (2**32 if start else 1 << 13) or pow_bits < 16


def test_sha256_channel_grinds_on_the_card(cuda):
    """The Sha256ProverChannel of a prover on the card grinds 24 bits there,
    one launch, and finds the host scan's nonce on the same transcript."""
    from recursive_stwo_tpu_torch.ops import sha256_cuda
    from recursive_stwo_tpu_torch.prover.commit import Sha256DeviceTree
    from recursive_stwo_tpu_torch.prover.prove import flavour
    from recursive_stwo_tpu_torch.prover.prove_sha256 import Sha256ProverChannel

    chans = []
    for device in (cuda, torch.device("cpu")):
        ch, _ = flavour(Sha256ProverChannel(), Sha256DeviceTree, device)
        ch.mix_root(np.arange(8, dtype=np.uint32) * 77_777)
        ch.mix_one_felt([1, 2, 3, 4])
        chans.append(ch)
    before = sha256_cuda.LAUNCHES["sha256_grind"]
    nonce = chans[0].grind_pow(24)
    assert sha256_cuda.LAUNCHES["sha256_grind"] == before + 1
    assert nonce == chans[1].grind_pow(24)
    assert sha256_cuda.LAUNCHES["sha256_grind"] == before + 1
    assert chans[0].ch.verify_pow_nonce(24, nonce)


def test_sha256_grind_kernel_keeps_every_value_in_registers(cuda):
    """ptxas' report of the build: the grind kernel has no stack frame and
    spills nothing."""
    from recursive_stwo_tpu_torch.ops import build

    build.load()
    report = build.ptxas_report("sha256_grind_kernel")
    assert len(report) == 1, report
    assert (report[0]["stack_bytes"], report[0]["spill_stores"], report[0]["spill_loads"]) == (0, 0, 0), report


def test_verify_batch_np_on_cuda_matches_host_reference(cuda):
    """np_small on CUDA with a flipped sibling and a flipped nonce: every
    check equals the JAX package's numpy verifier, through one transcript
    launch (no K1), two scans and one K2 leaf step."""
    from recursive_stwo_tpu.verifier.verify_np import verify_batch_np as r_verify_np
    from recursive_stwo_tpu_torch.verifier.verify_np import verify_batch_np as t_verify_np

    spec, pa1 = flagship.prepared_arrays_np("np_small")
    inputs = flagship.NP_FIXTURE_INPUTS["np_small"]
    pa = flagship.tiled_batch(pa1, 4)
    pa.tree_paths[1].sibling_hashes[2, 0, 0, 0] ^= np.uint32(1)
    pa.nonce_limbs[3] ^= np.uint32(1)
    ref = r_verify_np(spec, pa, inputs)
    launches.reset()
    got = t_verify_np(spec, to_torch(pa, cuda), inputs)
    torch.cuda.synchronize()
    _verifier_launches(launches.counts())
    assert list(ref) == list(got)
    for k in ref:
        assert np.array_equal(np.asarray(ref[k]), got[k].cpu().numpy()), k
    assert sorted(k for k, v in got.items() if not v[2]) == ["ok", "tree1"]
    assert not got["pow"][3]


def _corrupted_sha_checks(kind, device):
    step, arrays, fs = flagship.sha_checks_step(kind, 4, device=device)
    arrays.samples_flat[1, 0, 0] ^= 1
    fs.pow_digest0[2] ^= 1
    return step(arrays, fs)


@pytest.mark.parametrize("kind", ["level14", "bitcoin"])
def test_sha_device_checks_on_cuda_match_cpu(cuda, kind):
    got = _corrupted_sha_checks(kind, cuda)
    ref = _corrupted_sha_checks(kind, "cpu")
    assert list(ref) == list(got)
    for k in ref:
        assert torch.equal(ref[k], got[k].cpu()), k
    assert got["ok"].tolist() == [True, False, False, True]


@pytest.mark.parametrize("kind", ["level14", "bitcoin"])
def test_sha_fast_path_on_cuda_matches_cpu(cuda, kind):
    from recursive_stwo_tpu_torch.verifier import verify_sha256

    fn = verify_sha256.verify_sha256p31 if kind == "level14" else verify_sha256.verify_sha256np
    inputs = flagship.sha_inputs(kind)
    got = fn(flagship.sha_artifact(kind), inputs, device=cuda)
    ref = fn(flagship.sha_artifact(kind), inputs, device="cpu")
    assert list(ref) == list(got) and all(np.array_equal(ref[k], got[k]) for k in ref)
    assert got["ok"].all()


def test_sha_tree_on_cuda_matches_committed_tree(cuda, monkeypatch):
    """The SHA-256 tree with its columns on the card, hashed there by the
    SHA-256 kernel in blocks of 2**6 leaf rows: every level, the root and a
    decommitment equal the JAX package's Sha256CommittedTree."""
    from recursive_stwo_tpu.prover.commit import Sha256CommittedTree
    from recursive_stwo_tpu_torch.ops import sha256_cuda
    from recursive_stwo_tpu_torch.prover import commit

    monkeypatch.setattr(commit, "SHA_ROWS", 1 << 6)
    rng = np.random.default_rng(9)
    cols = {12: rng.integers(0, P, (7, 1 << 12)), 9: rng.integers(0, P, (4, 1 << 9))}
    ref = Sha256CommittedTree({L: c.astype(np.uint32) for L, c in cols.items()})
    sha256_cuda.reset_launches()
    tree = commit.Sha256DeviceTree({L: torch.from_numpy(c).to(cuda) for L, c in cols.items()})
    # 2**6 blocks of 7 levels each, then the 6 levels above them
    assert sha256_cuda.LAUNCHES["sha256_level"] == (1 << 6) * 7 + 6
    assert all(np.array_equal(g, w) for g, w in zip(tree.levels, ref.levels))
    assert np.array_equal(tree.root, ref.root)
    queries = [int(v) for v in rng.integers(0, 1 << 12, 9)]
    (vals, dec), (ref_vals, ref_dec) = tree.decommit(queries), ref.decommit(queries)
    assert np.array_equal(vals, ref_vals) and np.array_equal(dec.hash_witness, ref_dec.hash_witness)


def test_gloo_ranks_sharing_the_card_match_the_cpu_run(cuda):
    """tests/test_torch_mesh.py's cases on 2 gloo ranks on cuda:0: every
    named check of every slot, gathered, equals the JAX package's host
    verifier, and each rank launched every kernel of the verifier (the
    transcript kernel in place of K1)."""
    from test_torch_mesh import CASES, held, run_cases

    from recursive_stwo_tpu_torch.parallel import launch

    ranks = launch.spawn(run_cases, 2, "gloo", ("cuda:0",), timeout=300.0)
    for case in CASES:
        held(ranks, case)
    for r in ranks:
        got = r["launches"]
        assert got["transcript"] > 0 and got["permute_rows"] == 0, got
        assert all(got[k] > 0 for k in ("wordmajor_scan", "permute_wordmajor", "composition_check", "fold_phase")), got


@pytest.mark.parametrize("name", ["poseidon31", "sha256"])
def test_prove_np_on_cuda_matches_host(cuda, monkeypatch, name):
    """prove_np on CUDA against the JAX host prove_np in both flavours; the
    Merkle level kernel runs the Poseidon31 flavour's commits and none of
    the SHA-256 one's, K1 neither."""
    from recursive_stwo_tpu.proof.serialize import serialize_plonk_without_poseidon_proof as r_ser_np
    from recursive_stwo_tpu.prover.prove_np import prove_np as r_prove_np
    from recursive_stwo_tpu_torch.proof.serialize import serialize_plonk_without_poseidon_proof as t_ser_np
    from recursive_stwo_tpu_torch.prover.prove_np import prove_np as t_prove_np
    from test_torch_chain import NP_CONFIG, T_NP_CONFIG, _flavour, _np_trace

    launches.reset()
    got = t_prove_np(_np_trace(), T_NP_CONFIG, device=cuda, **_flavour(name, "port"))
    torch.cuda.synchronize()
    counts = launches.counts()
    assert (counts["merkle_level"] > 0) == (name == "poseidon31") and counts["permute_rows"] == 0, counts
    monkeypatch.setenv("RSTPU_DEVICE_PROVER", "0")
    ref = r_prove_np(_np_trace(), NP_CONFIG, **_flavour(name, "reference"))
    mode = "m31x8" if name == "poseidon31" else "bytes32"
    assert t_ser_np(got, mode) == r_ser_np(ref, mode)


def test_prove_sha256p31_on_cuda_matches_host(cuda, monkeypatch):
    from recursive_stwo_tpu.proof.serialize import serialize_plonk_with_poseidon_proof as r_ser
    from recursive_stwo_tpu.prover.prove_sha256 import prove_sha256p31 as r_prove_sha256p31
    from recursive_stwo_tpu_torch.prover.prove_sha256 import prove_sha256p31
    from test_torch_chain import CONFIG, T_CONFIG

    got = prove_sha256p31(flagship.demo_trace(), T_CONFIG, device=cuda)
    monkeypatch.setenv("RSTPU_DEVICE_PROVER", "0")
    assert flagship.proof_bytes(got) == r_ser(r_prove_sha256p31(flagship.demo_trace(), CONFIG), "bytes32")


@pytest.mark.parametrize("n", [1, 7, 127, 129, (1 << 20) + 3])
@pytest.mark.parametrize("n_cols,children", [(1, False), (13, False), (14, False), (40, False), (0, True),
                                             (4, True)])
def test_sha256_level_bit_exact(cuda, n, n_cols, children):
    """The SHA-256 tree-level kernel against its plain version and the JAX
    package's sha256_merkle level functions, at the tails of a warp and of a
    block; words of 2**31 and above in the children."""
    from recursive_stwo_tpu.verifier import sha256_merkle as r_merkle
    from recursive_stwo_tpu_torch.core import sha256 as t_sha
    from recursive_stwo_tpu_torch.ops import sha256_cuda

    rng = np.random.default_rng(n + n_cols)
    cols = rng.integers(0, P, (n_cols, n), dtype=np.int64)
    kids = rng.integers(0, 2**32, (2 * n, 8), dtype=np.int64) if children else None
    c = torch.from_numpy(cols).to(cuda) if n_cols else None
    k = None if kids is None else torch.from_numpy(kids).to(cuda)
    before = sha256_cuda.LAUNCHES["sha256_level"]
    got = sha256_cuda.sha256_level(k, c)
    torch.cuda.synchronize()
    assert sha256_cuda.LAUNCHES["sha256_level"] == before + 1
    assert torch.equal(got, t_sha.sha256_level_plain(k, c))
    if children:
        want = r_merkle.hash_node_level(kids.astype(np.uint32), cols.astype(np.uint32) if n_cols else None)
    else:
        want = r_merkle.hash_leaf_level(cols.astype(np.uint32))
    assert np.array_equal(got.cpu().numpy(), want.astype(np.int64))


@pytest.mark.parametrize("flavor", ["p31", "sha256"])
def test_streamed_tree_on_cuda_matches_cpu(cuda, flavor):
    """A StreamedTree of mixed eval/res sources on the card against the same
    tree on the CPU: root, decommitment and pair decommitment."""
    from test_torch_stream import TREE_CASES, TREE_CLASSES

    from recursive_stwo_tpu_torch.prover import fri_host, stream

    spec, chunking = TREE_CASES["mixed"]
    rng = np.random.default_rng(17)
    trees = {}
    for device in (cuda, torch.device("cpu")):
        sources = {}
        for L, n_cols, kind, blowup in spec:
            width = L - blowup if kind == "eval" else L
            x = torch.from_numpy(np.random.default_rng(L).integers(0, P, (n_cols, 1 << width))).to(device)
            sources[L] = stream.CoeffSource(x, L) if kind == "eval" else stream.ResidentSource(x)
        trees[device.type] = stream.StreamedTree(sources, TREE_CLASSES[flavor], **chunking)
    assert np.array_equal(trees["cuda"].root, trees["cpu"].root)
    queries = sorted(rng.integers(0, 1 << 12, 9).tolist())
    (v1, d1), (v2, d2) = trees["cuda"].decommit(queries), trees["cpu"].decommit(queries)
    assert np.array_equal(v1, v2) and np.array_equal(d1.hash_witness, d2.hash_witness)
    p1, p2 = (fri_host.decommit_pair(trees[k], queries) for k in ("cuda", "cpu"))
    assert np.array_equal(p1.hash_witness, p2.hash_witness)


def test_prove_streamed_on_cuda_matches_cpu(cuda):
    """The demo prove_streamed on CUDA against the CPU run, byte for byte;
    the Merkle level kernel commits its trees."""
    from recursive_stwo_tpu_torch.prover.stream import prove_streamed

    launches.reset()
    got = prove_streamed(flagship.demo_trace(), flagship.DEMO_CONFIG, device=cuda, chunk_log=9, cutoff=5)
    torch.cuda.synchronize()
    counts = launches.counts()
    assert counts["merkle_level"] > 0 and counts["permute_rows"] == 0, counts
    ref = prove_streamed(flagship.demo_trace(), flagship.DEMO_CONFIG, device="cpu", chunk_log=9, cutoff=5)
    assert flagship.proof_bytes(got) == flagship.proof_bytes(ref)


# the check kernel runs four proofs a block: batches of one, a block's tail,
# and around the main path's 1024
@pytest.mark.parametrize("batch", [1, 3, 7, 33, 1023, 1024])
@pytest.mark.parametrize("name", ["small_proof", "recursive_proof_16_15", "np_small", "level14", "bitcoin"])
def test_composition_check_bit_exact(cuda, name, batch):
    """The composition check kernel against its plain version on the card,
    on the Horner value and the bool, in one launch: the fixture with one
    sampled value corrupted, and random canonical inputs of its spec (where
    every constraint is nonzero)."""
    from recursive_stwo_tpu_torch.ops import composition_cuda
    from recursive_stwo_tpu_torch.tools import composition_cases as cases

    slot = batch // 2 if batch > 1 else None
    case = cases.check_case(name, batch, cuda, corrupt_slot=slot)
    for c in (case, cases.random_check_case(case.spec, batch, batch, cuda)):
        before = composition_cuda.LAUNCHES["composition_check"]
        ok, value = cases.check_value(c)
        torch.cuda.synchronize()
        assert composition_cuda.LAUNCHES["composition_check"] == before + 1
        ok_plain, value_plain = cases.check_value(c, plain=True)
        assert torch.equal(ok, ok_plain)
        assert all(torch.equal(got, want) for got, want in zip(value, value_plain))
    want = [True] * batch
    if slot is not None:
        want[slot] = False
    assert cases.check_value(case)[0].tolist() == want


@pytest.mark.parametrize("circuit", ["demo", "without-Poseidon demo", "level 1"])
def test_composition_domain_bit_exact(cuda, circuit):
    """The domain kernel against its plain version on the card, table by
    table into one accumulator, on the tables `prove` / `prove_np` hand
    their composition stage, and each table (every AIR) also accumulating
    into a random accumulator; composition_evals launches it once a
    table."""
    from test_torch_chain import T_NP_CONFIG, _np_trace

    from recursive_stwo_tpu_torch.ops import composition_cuda
    from recursive_stwo_tpu_torch.prover import composition as t_comp
    from recursive_stwo_tpu_torch.tools import composition_cases as cases

    if circuit == "demo":
        trace, config = flagship.demo_trace(), flagship.DEMO_CONFIG
    elif circuit == "level 1":
        trace, config, _ = flagship.chain_level_trace(1)
    else:
        trace, config = _np_trace(), T_NP_CONFIG
    spec, tables, lookup, rc = cases.prover_tables(trace, config, cuda, circuit.startswith("without"))
    acc = torch.zeros((4, 1 << spec.composition_log_degree_bound), dtype=torch.int64, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(7)
    for call in cases.domain_calls(spec, tables):
        plain = cases.run_domain(call, acc, lookup, rc, plain=True)
        assert torch.equal(cases.run_domain(call, acc.clone(), lookup, rc), plain)
        prev = torch.randint(0, P, tuple(acc.shape), generator=gen, device=cuda, dtype=torch.int64)
        onto = call._replace(first=False)
        assert torch.equal(cases.run_domain(onto, prev.clone(), lookup, rc),
                           cases.run_domain(onto, prev, lookup, rc, plain=True))
        acc = plain
    composition_cuda.reset_launches()
    assert torch.equal(t_comp.composition_evals(spec, tables, lookup, rc), acc)
    assert composition_cuda.LAUNCHES["composition_domain"] == len(tables)


def test_composition_kernels_launch_once_per_call(cuda):
    """On CUDA every verifier's composition check is one launch of the check
    kernel, and a proof's composition stage one launch of the domain kernel
    an AIR table."""
    from test_torch_chain import T_NP_CONFIG, _np_trace

    from recursive_stwo_tpu_torch.ops import launches
    from recursive_stwo_tpu_torch.prover.prove import prove
    from recursive_stwo_tpu_torch.prover.prove_np import prove_np
    from recursive_stwo_tpu_torch.verifier import verify_sha256

    step, arrays = flagship.verifier_step("small_proof", 8, device=cuda)
    step_np, arrays_np = flagship.verifier_step_np("np_small", 8, device=cuda)
    calls = {
        "verify_batch": (lambda: step(arrays), 1, 0),
        "verify_batch_np": (lambda: step_np(arrays_np), 1, 0),
        "device_checks_p31": (lambda: _corrupted_sha_checks("level14", cuda), 1, 0),
        "device_checks_np": (lambda: _corrupted_sha_checks("bitcoin", cuda), 1, 0),
        "verify_sha256p31": (lambda: verify_sha256.verify_sha256p31(
            flagship.sha_artifact("level14"), flagship.sha_inputs("level14"), device=cuda), 1, 0),
        "verify_sha256np": (lambda: verify_sha256.verify_sha256np(
            flagship.sha_artifact("bitcoin"), flagship.sha_inputs("bitcoin"), device=cuda), 1, 0),
        "prove": (lambda: prove(flagship.demo_trace(), flagship.DEMO_CONFIG, device=cuda), 0, 2),
        "prove_np": (lambda: prove_np(_np_trace(), T_NP_CONFIG, device=cuda), 0, 1),
    }
    for label, (fn, checks, tables) in calls.items():
        launches.reset()
        fn()
        torch.cuda.synchronize()
        got = launches.counts()
        assert (got["composition_check"], got["composition_domain"]) == (checks, tables), (label, got)


# the fold kernel runs a block a proof: batches of one, a few, a warp's
# worth and around the main path's 1024, at the fixtures' own Q of 16 and 8
@pytest.mark.parametrize("batch", [1, 3, 7, 33, 1023, 1024])
@pytest.mark.parametrize("name", ["small_proof", "recursive_proof_16_15", "np_small", "level14", "bitcoin"])
def test_fold_phase_bit_exact(cuda, name, batch):
    """The fold kernel against its plain version on the card, in one
    launch: answers, self values and the last-layer check, on the fixture
    with its four corrupted slots (a sampled value, a first-layer sibling,
    an inner-layer sibling, an OODS point whose quotient denominators are
    zero) and on random canonical inputs of its shapes."""
    from recursive_stwo_tpu_torch.ops import fold_cuda
    from recursive_stwo_tpu_torch.tools import fold_cases as cases

    case = cases.fold_case(name, batch, cuda, corrupt=True)
    for c in (case, cases.random_fold_case(name, batch, batch, cuda)):
        before = fold_cuda.LAUNCHES["fold_phase"]
        got = cases.fold_values(c)
        torch.cuda.synchronize()
        assert fold_cuda.LAUNCHES["fold_phase"] == before + 1
        want = cases.fold_values(c, plain=True)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    if batch > max(cases.CORRUPT_SLOTS):
        ok = cases.fold_values(case)[2].tolist()
        assert [b for b in range(batch) if not ok[b]] == list(cases.CORRUPT_SLOTS)


def test_redesigned_kernels_keep_every_value_in_registers_or_shared_memory(cuda):
    """ptxas' report of the build: the fold kernel and every instance of the
    composition check and domain kernels have no stack frame and spill
    nothing."""
    from recursive_stwo_tpu_torch.ops import build

    build.load()
    for name, instances in (("fold_kernel", 1), ("composition_domain_kernel", 3), ("composition_check_kernel", 2)):
        report = build.ptxas_report(name)
        assert len(report) == instances, (name, report)
        for r in report:
            assert (r["stack_bytes"], r["spill_stores"], r["spill_loads"]) == (0, 0, 0), r


def test_fold_phase_launches_once_per_verifier_call(cuda):
    """On CUDA every verifier's fold phase is one launch of the fold kernel:
    verify_batch, verify_batch_np and both SHA-256 device checks."""
    from recursive_stwo_tpu_torch.ops import launches

    step, arrays = flagship.verifier_step("small_proof", 8, device=cuda)
    step_np, arrays_np = flagship.verifier_step_np("np_small", 8, device=cuda)
    calls = {
        "verify_batch": lambda: step(arrays),
        "verify_batch_np": lambda: step_np(arrays_np),
        "device_checks_p31": lambda: _corrupted_sha_checks("level14", cuda),
        "device_checks_np": lambda: _corrupted_sha_checks("bitcoin", cuda),
    }
    for label, fn in calls.items():
        launches.reset()
        fn()
        torch.cuda.synchronize()
        assert launches.counts()["fold_phase"] == 1, (label, launches.counts())


# the transcript kernel runs sixteen proofs a block: batches of one, a
# block's tails, the main paths' 512 and 1024 and 1023
TRANSCRIPT_SHAPES = [(name, batch) for name in ("small_proof", "recursive_proof_16_15") for batch in (1, 3, 7, 33, 1023, 1024)]
TRANSCRIPT_SHAPES += [("np_small", batch) for batch in (1, 3, 33, 512)]


@pytest.mark.parametrize("name,batch", TRANSCRIPT_SHAPES)
def test_transcript_bit_exact(cuda, name, batch):
    """The transcript kernel against its plain version on the card, in one
    launch a call: every FSOutput field, the OODS point, the input sum and
    both checks, on the fixture with a flipped nonce and a flipped
    commitment word, with a wrong public input, with none, and on random
    canonical inputs with an input term planted at zero."""
    from recursive_stwo_tpu_torch.ops import transcript_cuda
    from recursive_stwo_tpu_torch.tools import transcript_cases as cases

    for c in (cases.transcript_case(name, batch, cuda, corrupt=True),
              cases.transcript_case(name, batch, cuda, inputs=((1, (2, 0, 0, 0)),)),
              cases.transcript_case(name, batch, cuda, inputs=()),
              cases.random_transcript_case(name, batch, batch, cuda)):
        before = transcript_cuda.LAUNCHES["transcript"]
        got = cases.replay_fields(c)
        torch.cuda.synchronize()
        assert transcript_cuda.LAUNCHES["transcript"] == before + 1
        want = cases.replay_fields(c, plain=True)
        assert list(got) == list(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_transcript_empty_batch_launches_nothing(cuda):
    from recursive_stwo_tpu_torch.ops import transcript_cuda
    from recursive_stwo_tpu_torch.tools import transcript_cases as cases

    c = cases.transcript_case("small_proof", 0, cuda)
    before = transcript_cuda.LAUNCHES["transcript"]
    out, ok = transcript_cuda.transcript(c.spec, c.pa, c.inputs)
    assert out.shape[0] == ok.shape[0] == 0 and transcript_cuda.LAUNCHES["transcript"] == before


def test_transcript_launches_once_per_verifier_call(cuda):
    """verify_batch and verify_batch_np on CUDA: the transcript, its draws,
    the OODS point and the input sum in one launch, K1 never."""
    step, arrays = flagship.verifier_step("small_proof", 8, device=cuda)
    step_np, arrays_np = flagship.verifier_step_np("np_small", 8, device=cuda)
    for label, fn in (("verify_batch", lambda: step(arrays)), ("verify_batch_np", lambda: step_np(arrays_np))):
        launches.reset()
        assert bool(fn()["ok"].all()), label
        torch.cuda.synchronize()
        _verifier_launches(launches.counts())


def test_latency_probe_times_each_step_kind(cuda):
    """The latency probe (csrc/latency.cu) on one warp: a positive cycle
    count a step of every kind, and the SM clock between 0.5 and 3 GHz."""
    from recursive_stwo_tpu_torch.ops import latency_cuda

    lat = latency_cuda.step_latencies(cuda)
    assert set(lat) == set(latency_cuda.KINDS) | {"ghz"}
    assert all(lat[k] > 0 for k in latency_cuda.KINDS), lat
    assert 0.5 < lat["ghz"] < 3.0, lat


# ---- the provers' circle FFT and quotient kernels ----------------------------
# (csrc/circle_fft.cu, csrc/quotients.cu)

# (log n, columns): one point, one butterfly, one radix-8 round, a block's
# tile of 2**13 and below it, clusters of 2, 4 and 8 blocks (2**14-2**18, the
# last of 2**15-word blocks), two passes (2**19-2**21), a single column
FFT_SHAPES = [(0, 1), (1, 1), (3, 2), (5, 3), (11, 1), (12, 5), (13, 2), (14, 1), (15, 3), (16, 2), (17, 3),
              (18, 2), (19, 1), (20, 1), (21, 9)]


@pytest.mark.parametrize("log_size,cols", FFT_SHAPES)
def test_circle_fft_bit_exact(cuda, log_size, cols):
    """interpolate, evaluate and the LDE to 2 and 8 times the size against
    their plain versions on the card, each one launch of the wrapper."""
    from recursive_stwo_tpu_torch.ops import fft_cuda
    from recursive_stwo_tpu_torch.prover import circle_fft

    gen = torch.Generator(device=cuda).manual_seed(log_size)
    x = torch.randint(0, P, (cols, 1 << log_size), generator=gen, device=cuda, dtype=torch.int64)
    x[0, -1] = P - 1
    before = fft_cuda.LAUNCHES["circle_fft"]
    c = fft_cuda.interpolate(x)
    assert torch.equal(c, circle_fft.interpolate_plain(x))
    assert torch.equal(fft_cuda.evaluate(c, log_size), x)
    assert torch.equal(fft_cuda.evaluate(x, log_size), circle_fft.evaluate_plain(x))
    for blowup in (1, 3):
        want = circle_fft.evaluate_plain(circle_fft.extend(x, log_size + blowup))
        assert torch.equal(fft_cuda.evaluate(x, log_size + blowup), want)
    torch.cuda.synchronize()
    assert fft_cuda.LAUNCHES["circle_fft"] == before + 5


@pytest.mark.parametrize("name", ["level1-5", "level2-1"])
def test_circle_fft_bit_exact_at_prover_shapes(cuda, name):
    """Every interpolation and LDE of a chain level's prover, at its shapes
    (tools/prover_cases.fft_cases), against the plain versions."""
    from recursive_stwo_tpu_torch.tools import prover_cases as cases

    for case in cases.fft_cases(cases.prover_spec(name), cuda, seed=3):
        assert torch.equal(cases.run_fft(case), cases.run_fft(case, plain=True)), case.label


@pytest.mark.parametrize("log_size,segments", [(12, 1), (12, 2), (12, 512), (17, 2), (15, 512), (18, 8)])
def test_circle_fft_lde_segments(cuda, log_size, segments):
    """LDEs of G = 1, 2, 512 and 8 segments: several segments a block below
    its tile, one a cluster above it (level 2's tree-1 shape, 2**18 to 2**21)."""
    from recursive_stwo_tpu_torch.ops import fft_cuda
    from recursive_stwo_tpu_torch.prover import circle_fft

    gen = torch.Generator(device=cuda).manual_seed(log_size + segments)
    x = torch.randint(0, P, (3, 1 << log_size), generator=gen, device=cuda, dtype=torch.int64)
    log = log_size + segments.bit_length() - 1
    assert torch.equal(fft_cuda.evaluate(x, log), circle_fft.evaluate_plain(circle_fft.extend(x, log)))


def test_circle_fft_reads_rows_off_16_bytes(cuda):
    """Rows that start off a 16-byte boundary (an odd row stride, an odd
    offset) take the one-word loads where aligned rows take 16 bytes."""
    from recursive_stwo_tpu_torch.ops import fft_cuda
    from recursive_stwo_tpu_torch.prover import circle_fft

    gen = torch.Generator(device=cuda).manual_seed(9)
    for log in (3, 12, 16):
        x = torch.randint(0, P, (3, (1 << log) + 1), generator=gen, device=cuda, dtype=torch.int64)[:, 1:]
        assert x.stride(0) % 2 == 1
        assert torch.equal(fft_cuda.interpolate(x), circle_fft.interpolate_plain(x)), log
        assert torch.equal(fft_cuda.evaluate(x, log + 1), circle_fft.evaluate_plain(circle_fft.extend(x, log + 1)))


def test_circle_fft_past_2_31_elements(cuda):
    """An LDE whose output passes 2**31 elements (17 columns of 2**27): its
    first and last columns against the plain version of each alone."""
    from recursive_stwo_tpu_torch.ops import fft_cuda
    from recursive_stwo_tpu_torch.prover import circle_fft

    gen = torch.Generator(device=cuda).manual_seed(31)
    x = torch.randint(0, P, (17, 1 << 18), generator=gen, device=cuda, dtype=torch.int64)
    out = fft_cuda.evaluate(x, 27)
    assert out.shape == (17, 1 << 27) and out.numel() > 2**31
    for col in (0, 16):
        assert torch.equal(out[col], circle_fft.evaluate_plain(circle_fft.extend(x[col : col + 1], 27))[0]), col
    del out
    torch.cuda.empty_cache()


# (T, b, t0, t1, widths): tiles of one butterfly, a tile within a block and
# many tiles a block, several coefficient blocks, a block's tile, level 14's
# tiles of 2**15 on clusters of 4, chain level 3's streamed chunk (three
# blocks of 2**17 on 8 tiles) and an odd number of such tiles
TILE_SHAPES = [(6, 1, 0, 32, (3,)), (12, 9, 2, 6, (2, 1, 5)), (10, 4, 5, 61, (1,)), (16, 13, 3, 7, (4,)),
               (20, 15, 4, 12, (3, 5, 2)), (22, 17, 8, 16, (10, 12, 8)), (24, 17, 3, 8, (2, 3))]


@pytest.mark.parametrize("T,b,t0,t1,widths", TILE_SHAPES)
def test_eval_tiles_bit_exact(cuda, T, b, t0, t1, widths):
    """The tile kernel against the plain tile evaluation (the blocks
    concatenated), one launch a call."""
    from recursive_stwo_tpu_torch.ops import fft_cuda
    from recursive_stwo_tpu_torch.prover import stream, tiles

    gen = torch.Generator(device=cuda).manual_seed(T + b)
    blocks = [torch.randint(0, P, (w, 1 << b), generator=gen, device=cuda, dtype=torch.int64) for w in widths]
    tp = tiles.circle_tiles(T, b, t0, t1, cuda)
    before = fft_cuda.LAUNCHES["eval_tiles"]
    got = fft_cuda.eval_tiles(blocks, tp.bx, tp.by, tp.tx, tp.ty)
    torch.cuda.synchronize()
    assert fft_cuda.LAUNCHES["eval_tiles"] == before + 1
    cat = torch.cat(blocks)
    cx, cy = tp.points()
    want = stream._eval_tiles(cat, stream._tile_twiddles(cx, cy, b), b, t1 - t0).reshape(cat.shape[0], -1)
    assert torch.equal(got, want)


def test_eval_tiles_of_one_coefficient(cuda):
    """b = 0: every tile is the column's one coefficient."""
    from recursive_stwo_tpu_torch.ops import fft_cuda

    c = torch.arange(3, dtype=torch.int64, device=cuda)[:, None] + 5
    z = torch.zeros(7, dtype=torch.int64, device=cuda)
    got = fft_cuda.eval_tiles([c], z, z, torch.ones(1, dtype=torch.int64, device=cuda), z[:1])
    assert torch.equal(got, c.expand(3, 7))


# (artifact, group, chunk log): level 2's groups resident (2**23, 2**22 and
# 2**21 points), level 3's shapes streamed, the last layer's chunk of 2**20
# in tiles of 2**18
QUOTIENT_SHAPES = [("level2-1", 0, None), ("level2-1", 1, None), ("level2-1", 2, None), ("level1-5", 2, 20),
                   ("bitcoin_proof", 0, 20), ("bitcoin_proof", 1, 20)]


@pytest.mark.parametrize("name,g,chunk_log", QUOTIENT_SHAPES)
def test_quotients_bit_exact_at_prover_shapes(cuda, name, g, chunk_log):
    """The quotient kernel against group_answers_plain on random columns of
    a chain proof's group, one launch a call; and with the OODS point on the
    domain's first point (the OODS batch's denominators zero there: inv(0) =
    0 in both)."""
    from recursive_stwo_tpu_torch.ops import quotients_cuda
    from recursive_stwo_tpu_torch.tools import prover_cases as cases

    case = cases.quotient_case(cases.prover_spec(name), g, cuda, seed=g, chunk_log=chunk_log)
    before = quotients_cuda.LAUNCHES["quotients"]
    got = cases.run_quotients(case)
    torch.cuda.synchronize()
    assert quotients_cuda.LAUNCHES["quotients"] == before + 1
    assert torch.equal(got, cases.run_quotients(case, plain=True))
    if chunk_log is None:
        x, y = (int(v[0]) for v in case.points)
        on_domain = case._replace(inputs=case.inputs._replace(oods=(x, 0, 0, 0, y, 0, 0, 0)))
        assert torch.equal(cases.run_quotients(on_domain), cases.run_quotients(on_domain, plain=True))


def _no_plain_on_cuda(monkeypatch):
    """Make every plain FFT, tile and quotient version raise when handed a
    CUDA tensor."""
    from recursive_stwo_tpu_torch.prover import circle_fft, quotients, stream

    for module, name in ((circle_fft, "interpolate_plain"), (circle_fft, "evaluate_plain"), (stream, "_eval_tiles"),
                         (quotients, "group_answers_plain")):
        real = getattr(module, name)

        def guard(*args, real=real, name=name, **kw):
            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                raise AssertionError(f"{name} ran on a CUDA tensor")
            for a in args:
                if isinstance(a, list) and any(isinstance(t, torch.Tensor) and t.is_cuda for t in a):
                    raise AssertionError(f"{name} ran on a CUDA tensor")
            return real(*args, **kw)

        monkeypatch.setattr(module, name, guard)


@pytest.mark.parametrize("prover", ["prove", "prove_np", "prove_streamed", "prove_np_streamed"])
def test_provers_run_fft_and_quotients_on_the_kernels(cuda, monkeypatch, prover):
    """On CUDA every prover's transforms, tile evaluations and first-layer
    quotients go through the kernels, never their plain versions: the FFT
    launches, the quotient kernel once a first-layer group (resident) or a
    streamed chunk; the proof equals the CPU run's."""
    from test_torch_chain import T_NP_CONFIG, _np_trace

    from recursive_stwo_tpu_torch.ops import launches
    from recursive_stwo_tpu_torch.prover.prove import prove
    from recursive_stwo_tpu_torch.prover.prove_np import prove_np
    from recursive_stwo_tpu_torch.prover.stream import prove_np_streamed, prove_streamed
    from recursive_stwo_tpu_torch.tools import prover_cases as cases
    from recursive_stwo_tpu_torch.verifier.spec import NoPoseidonVerifierSpec, VerifierSpec

    stream_args = dict(chunk_log=6, cutoff=4)
    run = {
        "prove": lambda d: prove(flagship.demo_trace(), flagship.DEMO_CONFIG, device=d),
        "prove_np": lambda d: prove_np(_np_trace(), T_NP_CONFIG, device=d),
        "prove_streamed": lambda d: prove_streamed(flagship.demo_trace(), flagship.DEMO_CONFIG, device=d, **stream_args),
        "prove_np_streamed": lambda d: prove_np_streamed(_np_trace(), T_NP_CONFIG, device=d, **stream_args),
    }[prover]
    want = run("cpu")
    _no_plain_on_cuda(monkeypatch)
    launches.reset()
    got = run(cuda)
    torch.cuda.synchronize()
    counts = launches.counts()
    assert flagship.proof_bytes(got) == flagship.proof_bytes(want)
    spec = (NoPoseidonVerifierSpec.for_rows(got.log_size, got.config) if prover.startswith("prove_np")
            else VerifierSpec.from_proof(got))
    assert counts["circle_fft"] > 0, counts
    if prover.endswith("streamed"):
        assert counts["eval_tiles"] > 0, counts
        assert counts["quotients"] == cases.n_chunks(spec, stream_args["chunk_log"]), counts
    else:
        assert counts["eval_tiles"] == 0 and counts["quotients"] == len(spec.all_log_sizes), counts


def test_fft_and_quotient_kernels_keep_every_value_in_registers_or_shared_memory(cuda):
    """ptxas' report of the build: the FFT pass kernel's four instances
    (interpolation; evaluation and tiles; each for clusters of up to 8 and
    of 16), the tile twiddle kernel and both quotient kernels have no stack
    frame and spill nothing."""
    from recursive_stwo_tpu_torch.ops import build

    build.load()
    for name, instances in (("fft_pass_kernel", 4), ("fft_tile_twiddle_kernel", 1), ("quotient_coeffs_kernel", 1),
                            ("quotient_points_kernel", 1)):
        report = build.ptxas_report(name)
        assert len(report) == instances, (name, report)
        for r in report:
            assert (r["stack_bytes"], r["spill_stores"], r["spill_loads"]) == (0, 0, 0), r


# ---- the provers' sampling and interaction kernels ----------------------------
# (csrc/sample.cu, csrc/interaction.cu)


@pytest.mark.parametrize("name", ["level1-5", "level2-1", "level14-1", "bitcoin_proof"])
def test_sample_bit_exact_at_prover_shapes(cuda, name):
    """Every block and point a proof of the committed chain proof's shape
    samples, in one launch, against the plain version block by block."""
    from recursive_stwo_tpu_torch.ops import sample_cuda
    from recursive_stwo_tpu_torch.tools import prover_cases as cases

    case = cases.sample_case(cases.prover_spec(name), cuda, seed=3)
    before = sample_cuda.LAUNCHES["sample"]
    got = cases.run_sample(case)
    torch.cuda.synchronize()
    assert sample_cuda.LAUNCHES["sample"] == before + 1
    assert torch.equal(got, cases.run_sample(case, plain=True))


@pytest.mark.parametrize("logs,points", [((0,), 1), ((0, 1, 2), 2), ((5, 9, 10, 11), 1), ((13, 16, 17), 2),
                                         ((20,), 2), ((22,), 1)])
def test_sample_bit_exact_at_every_split(cuda, logs, points):
    """Blocks whose log sizes cross each split of csrc/sample.cu (a run of
    2**L below 2**10, a block's Hi table below 2**6, chunks above), one of
    them a view of every other row, the constant polynomial, and every
    coefficient and factor at p - 1 (the lazy sums' largest products)."""
    from recursive_stwo_tpu_torch.ops import sample_cuda
    from recursive_stwo_tpu_torch.prover import sample

    gen = torch.Generator(device=cuda).manual_seed(sum(logs))
    rng = np.random.default_rng(sum(logs))
    for extreme in (False, True):
        jobs = []
        for k, n in enumerate(logs):
            c = torch.randint(0, P, (6, 1 << n), generator=gen, device=cuda, dtype=torch.int64)
            c = c[::2] if k == 0 else c
            facs = [rng.integers(0, P, (n, 4)) for _ in range(points)]
            if extreme:
                c = torch.full_like(c, P - 1)
                facs = [np.full((n, 4), P - 1, np.int64) for _ in range(points)]
            jobs.append((c, facs))
        out, firsts = sample_cuda.sample_columns(jobs)
        torch.cuda.synchronize()
        for (c, facs), r in zip(jobs, firsts):
            for p, f in enumerate(facs):
                want = sample.sample(c, f)
                assert np.array_equal(out[r + p * c.shape[0]: r + (p + 1) * c.shape[0]].cpu().numpy(), want)


@pytest.mark.parametrize("name", ["level1-5", "level2-1", "bitcoin_proof"])
def test_interaction_bit_exact(cuda, name):
    """Each AIR table of the chain proof's shape, one launch a table, against
    the plain version, and with a zero denominator planted (inv(0) = 0)."""
    from recursive_stwo_tpu_torch.ops import interaction_cuda
    from recursive_stwo_tpu_torch.tools import prover_cases as cases

    spec = cases.prover_spec(name)
    for zero_row in (None, 12345):
        for case in cases.interaction_cases(spec, cuda, seed=5, zero_row=zero_row):
            before = interaction_cuda.LAUNCHES["interaction"]
            got = cases.run_interaction(case)
            torch.cuda.synchronize()
            assert interaction_cuda.LAUNCHES["interaction"] == before + 1
            assert torch.equal(got, cases.run_interaction(case, plain=True)), case.label


def _no_eager_sample_or_interaction_on_cuda(monkeypatch):
    """Make the plain sampling and the plain interaction rows raise when
    handed a CUDA tensor."""
    from recursive_stwo_tpu_torch.prover import interaction, sample

    for module, name in ((sample, "sample"), (interaction, "interaction_rows_plain")):
        real = getattr(module, name)

        def guard(x, *args, real=real, name=name, **kw):
            if x.is_cuda:
                raise AssertionError(f"{name} ran on a CUDA tensor")
            return real(x, *args, **kw)

        monkeypatch.setattr(module, name, guard)


@pytest.mark.parametrize("prover", ["prove", "prove_sha256p31", "prove_np", "prove_streamed", "prove_np_streamed"])
def test_provers_run_sample_and_interaction_on_the_kernels(cuda, monkeypatch, prover):
    """On CUDA every prover samples every block and point in one launch of
    the sampling kernel and generates each table's interaction columns in
    one launch of the interaction kernel, never the plain versions; the
    proof equals the CPU run's."""
    from test_torch_chain import T_NP_CONFIG, _np_trace

    from recursive_stwo_tpu_torch.prover.commit import Sha256DeviceTree
    from recursive_stwo_tpu_torch.prover.prove import prove
    from recursive_stwo_tpu_torch.prover.prove_np import prove_np
    from recursive_stwo_tpu_torch.prover.prove_sha256 import Sha256ProverChannel
    from recursive_stwo_tpu_torch.prover.stream import prove_np_streamed, prove_streamed

    stream_args = dict(chunk_log=6, cutoff=4)
    run = {
        "prove": lambda d: prove(flagship.demo_trace(), flagship.DEMO_CONFIG, device=d),
        "prove_sha256p31": lambda d: prove(flagship.demo_trace(), flagship.DEMO_CONFIG, device=d,
                                           channel=Sha256ProverChannel(), tree_cls=Sha256DeviceTree),
        "prove_np": lambda d: prove_np(_np_trace(), T_NP_CONFIG, device=d),
        "prove_streamed": lambda d: prove_streamed(flagship.demo_trace(), flagship.DEMO_CONFIG, device=d, **stream_args),
        "prove_np_streamed": lambda d: prove_np_streamed(_np_trace(), T_NP_CONFIG, device=d, **stream_args),
    }[prover]
    want = run("cpu")
    _no_eager_sample_or_interaction_on_cuda(monkeypatch)
    launches.reset()
    got = run(cuda)
    torch.cuda.synchronize()
    counts = launches.counts()
    assert flagship.proof_bytes(got) == flagship.proof_bytes(want)
    assert counts["sample"] == 1, counts
    assert counts["interaction"] == (1 if prover.startswith("prove_np") else 2), counts


def test_sample_and_interaction_kernels_keep_every_value_in_registers_or_shared_memory(cuda):
    """ptxas' report of the build: the sampling kernel, its finishing kernel
    and the interaction kernel's three instances have no stack frame and
    spill nothing; the interaction kernel's poseidon instance uses fewer
    registers than the domain kernel's (its rounds are not compiled in)."""
    from recursive_stwo_tpu_torch.ops import build

    build.load()
    for name, instances in (("sample_kernel", 1), ("sample_finish_kernel", 1), ("interaction_kernel", 3)):
        report = build.ptxas_report(name)
        assert len(report) == instances, (name, report)
        for r in report:
            assert (r["stack_bytes"], r["spill_stores"], r["spill_loads"]) == (0, 0, 0), r
    gen = max(r["registers"] for r in build.ptxas_report("interaction_kernel"))
    assert gen < max(r["registers"] for r in build.ptxas_report("composition_domain_kernel"))


def test_interaction_poseidon_instance_is_shorter_than_the_domain_kernels(cuda):
    """cuobjdump's SASS of the build: the interaction kernel's poseidon
    instance (generation mode, no rounds) has fewer than half the
    instructions of the domain kernel's poseidon instance."""
    from recursive_stwo_tpu_torch.ops import build

    build.load()
    gen = [r["instructions"] for r in build.sass_instructions("interaction_kernelILi1E")]
    dom = [r["instructions"] for r in build.sass_instructions("composition_domain_kernelILi1E")]
    assert len(gen) == len(dom) == 1 and 0 < 2 * gen[0] < dom[0], (gen, dom)


# ---- the FRI fold-layer and Merkle level kernels (csrc/fri_fold.cu, csrc/merkle.cu) ----


@pytest.mark.parametrize("n", [1, 2, 3, 17])
@pytest.mark.parametrize("line,circle", [(True, False), (False, True), (True, True)])
def test_fri_fold_bit_exact(cuda, n, line, circle):
    """One fold layer (a line fold, a join alone, both) in one launch
    against fold_layer_plain."""
    from recursive_stwo_tpu_torch.ops import fri_fold_cuda
    from recursive_stwo_tpu_torch.tools import prover_cases as cases

    case = cases.fold_case(n, line, circle, cuda, seed=n)
    before = fri_fold_cuda.LAUNCHES["fri_fold"]
    got = cases.run_fold(case)
    torch.cuda.synchronize()
    assert fri_fold_cuda.LAUNCHES["fri_fold"] == before + 1
    assert torch.equal(got, cases.run_fold(case, plain=True)), case.label


@pytest.mark.parametrize("name", ["level1-5", "level2-1", "level14-1", "bitcoin_proof"])
def test_fri_fold_bit_exact_at_prover_shapes(cuda, name):
    """Every fold launch of the chain proof's FRI layers (the last layer's
    first a circle fold of (4, 2**27)) against the plain version."""
    from recursive_stwo_tpu_torch.tools import prover_cases as cases

    for k, (log, line, circle) in enumerate(cases.fold_shapes(cases.prover_spec(name))):
        case = cases.fold_case(log, line, circle, cuda, seed=k)
        got = cases.run_fold(case)
        assert torch.equal(got, cases.run_fold(case, plain=True)), case.label
        del case, got
        torch.cuda.empty_cache()


@pytest.mark.parametrize("n_cols", [0, 1, 8, 9, 134])
@pytest.mark.parametrize("rows", [1, 7, (1 << 20) + 3])
def test_merkle_level_bit_exact(cuda, n_cols, rows):
    """Leaf and node levels of n_cols columns at `rows` nodes in one launch
    each against level_plain."""
    from recursive_stwo_tpu_torch.ops import merkle_cuda
    from recursive_stwo_tpu_torch.tools import prover_cases as cases

    for node in (False, True):
        if not n_cols and not node:
            continue
        case = cases.merkle_case(n_cols, (rows - 1).bit_length(), cuda, seed=rows, node=node, rows=rows)
        before = merkle_cuda.LAUNCHES["merkle_level"]
        got = cases.run_merkle(case)
        torch.cuda.synchronize()
        assert merkle_cuda.LAUNCHES["merkle_level"] == before + 1
        assert torch.equal(got, cases.run_merkle(case, plain=True)), case.label


def test_merkle_level_reads_a_strided_view(cuda):
    """A streamed chunk's columns, a view of a wider tensor, against the
    plain version on the same view and on its contiguous copy."""
    from recursive_stwo_tpu_torch.tools import prover_cases as cases

    case = cases.merkle_tree_case(cases.prover_spec("level2-1"), 1, cuda, seed=3, rows=(1 << 16) + 5)
    assert not case.cols.is_contiguous()
    got = cases.run_merkle(case)
    assert torch.equal(got, cases.run_merkle(case, plain=True))
    assert torch.equal(got, cases.run_merkle(case._replace(cols=case.cols.contiguous())))


PROVERS = ["prove", "prove_sha256p31", "prove_np", "prove_streamed", "prove_np_streamed"]


def _demo_prover(prover):
    """device -> the demo proof of `prover` (one of PROVERS) on that device."""
    from test_torch_chain import T_NP_CONFIG, _np_trace

    from recursive_stwo_tpu_torch.prover.commit import Sha256DeviceTree
    from recursive_stwo_tpu_torch.prover.prove import prove
    from recursive_stwo_tpu_torch.prover.prove_np import prove_np
    from recursive_stwo_tpu_torch.prover.prove_sha256 import Sha256ProverChannel
    from recursive_stwo_tpu_torch.prover.stream import prove_np_streamed, prove_streamed

    stream_args = dict(chunk_log=6, cutoff=4)
    return {
        "prove": lambda d: prove(flagship.demo_trace(), flagship.DEMO_CONFIG, device=d),
        "prove_sha256p31": lambda d: prove(flagship.demo_trace(), flagship.DEMO_CONFIG, device=d,
                                           channel=Sha256ProverChannel(), tree_cls=Sha256DeviceTree),
        "prove_np": lambda d: prove_np(_np_trace(), T_NP_CONFIG, device=d),
        "prove_streamed": lambda d: prove_streamed(flagship.demo_trace(), flagship.DEMO_CONFIG, device=d, **stream_args),
        "prove_np_streamed": lambda d: prove_np_streamed(_np_trace(), T_NP_CONFIG, device=d, **stream_args),
    }[prover]


@pytest.mark.parametrize("prover", PROVERS)
def test_provers_run_folds_and_merkle_levels_on_the_kernels(cuda, monkeypatch, prover):
    """On CUDA every prover folds in spec.n_inner_layers + 1 launches of the
    fold-layer kernel and hashes its Poseidon31 trees on the Merkle level
    kernel, never the plain versions and never K1 (the demo's 5-bit PoW is
    the host's in the Poseidon31 flavour), the SHA-256 grind kernel once in
    the Sha256Poseidon31 flavour; the proof equals the CPU run's."""
    from recursive_stwo_tpu_torch.prover import commit, fri
    from recursive_stwo_tpu_torch.verifier.spec import NoPoseidonVerifierSpec, VerifierSpec

    run = _demo_prover(prover)
    want = run("cpu")

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on CUDA")

    monkeypatch.setattr(fri, "fold_layer_plain", refuse)
    monkeypatch.setattr(commit, "level_plain", refuse)
    launches.reset()
    got = run(cuda)
    torch.cuda.synchronize()
    counts = launches.counts()
    assert flagship.proof_bytes(got) == flagship.proof_bytes(want)
    spec = (NoPoseidonVerifierSpec.for_rows(got.log_size, got.config) if prover.startswith("prove_np")
            else VerifierSpec.from_proof(got))
    assert counts["fri_fold"] == spec.n_inner_layers + 1, counts
    assert (counts["merkle_level"] > 0) == (prover != "prove_sha256p31"), counts
    assert counts["permute_rows"] == 0 and counts["sha256_grind"] == (prover == "prove_sha256p31"), counts


# ---- the FRI last-layer kernel (csrc/fri_fold.cu `fri_last_kernel`) ----


@pytest.mark.parametrize("level,bound", [(1, 0), (2, 1), (4, 2), (5, 5), (9, 0), (12, 5), (13, 8), (14, 3), (16, 7),
                                         (17, 7), (20, 7), (23, 7)])
def test_fri_last_bit_exact(cuda, level, bound):
    """One launch of the last-layer kernel against the plain version on the
    same card tensor: the kept coefficients in the verifier's order, every
    count 0, and last_layer_poly's rows; from one cluster block a column to
    clusters of 8 with 128 slabs a rank."""
    from recursive_stwo_tpu_torch.ops import fri_fold_cuda
    from recursive_stwo_tpu_torch.prover import fri_last
    from recursive_stwo_tpu_torch.tools import prover_cases as cases

    case = cases.last_layer_case(level, bound, cuda, seed=level)
    before = fri_fold_cuda.LAUNCHES["fri_last"]
    got = cases.run_last(case)
    torch.cuda.synchronize()
    assert fri_fold_cuda.LAUNCHES["fri_last"] == before + 1
    got = got.cpu().numpy()
    want = cases.run_last(case, plain=True)
    assert np.array_equal(got[: 4 << bound].reshape(-1, 4), want.astype(np.int64)), case.label
    assert list(got[4 << bound :]) == [0] * 4, case.label
    assert np.array_equal(fri_last.last_layer_poly(case.g, level, bound), want)


@pytest.mark.parametrize("level,bound", [(2, 1), (9, 0), (16, 7), (20, 7)])
def test_fri_last_counts_coefficients_past_the_bound(cuda, level, bound):
    """Coefficients planted past the bound (the first such position, the
    last, one in the middle) are counted in every column, and
    last_layer_poly raises the copy's ValueError."""
    from recursive_stwo_tpu_torch.prover import fri_last
    from recursive_stwo_tpu_torch.tools import prover_cases as cases

    n = 1 << level
    for planted in ((1 << bound,), (n - 1,), (1 << bound, n // 2 + 1, n - 1)):
        case = cases.last_layer_case(level, bound, cuda, seed=len(planted), planted=planted)
        words = cases.run_last(case).cpu().numpy()
        assert list(words[4 << bound :]) == [len(set(planted))] * 4, case.label
        with pytest.raises(ValueError, match=fri_last.DEGREE_ERROR):
            fri_last.last_layer_poly(case.g, level, bound)


@pytest.mark.parametrize("prover", PROVERS)
def test_provers_run_the_last_layer_on_the_kernel(cuda, monkeypatch, prover):
    """On CUDA every prover, resident and streamed, takes its last layer in
    one launch of the last-layer kernel, never the plain version; the proof's
    bytes equal the CPU run's, which took the plain version."""
    from recursive_stwo_tpu_torch.prover import fri_last

    run = _demo_prover(prover)
    want = run("cpu")

    def refuse(*a, **k):
        raise AssertionError("the plain last layer ran on CUDA")

    monkeypatch.setattr(fri_last, "last_layer_poly_plain", refuse)
    launches.reset()
    got = run(cuda)
    torch.cuda.synchronize()
    assert launches.counts()["fri_last"] == 1
    assert flagship.proof_bytes(got) == flagship.proof_bytes(want)


def test_fri_fold_and_merkle_kernels_keep_every_value_in_registers(cuda):
    """ptxas' report of the build: the fold-layer kernel's three instances,
    the Merkle level kernel and the last-layer kernel have no stack frame and
    spill nothing."""
    from recursive_stwo_tpu_torch.ops import build

    build.load()
    for name, instances in (("fri_layer_kernel", 3), ("merkle_level_kernel", 1), ("fri_last_kernel", 1)):
        report = build.ptxas_report(name)
        assert len(report) == instances, (name, report)
        for r in report:
            assert (r["stack_bytes"], r["spill_stores"], r["spill_loads"]) == (0, 0, 0), r


class _NoRange:
    """A stand-in for the spans' range: nothing recorded."""

    def __init__(self, name):
        pass

    def __enter__(self):
        pass

    def __exit__(self, *exc):
        pass


def _traced_events(fn) -> list:
    """(name, device type) of every event of fn traced on the host and the
    card, taken again (up to three times) when CUPTI returns no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [(e.name(), e.device_type()) for e in prof.profiler.kineto_results.events()]
        if any(d == DeviceType.CUDA for _, d in events):
            return events
    raise AssertionError("three traces recorded no device event")


@pytest.mark.parametrize("what", ["verify_batch", "prove"])
def test_spans_add_nothing_to_the_card_timeline(cuda, monkeypatch, what):
    """A verify_batch at B=1024 and a proof of the demo circuit, traced: no
    rstpu. span has a CUDA device type (a copy of it on the card's timeline
    would count as device work), and the card runs the same kernels with
    the spans as with them recording nothing."""
    from torch.autograd import DeviceType

    from recursive_stwo_tpu_torch.prover.prove import prove as t_prove
    from recursive_stwo_tpu_torch.utils import spans

    if what == "verify_batch":
        step, arrays = flagship.verifier_step("recursive_proof_16_15", 1024, device=cuda)
        run = lambda: step(arrays)  # noqa: E731
    else:
        trace = flagship.demo_trace()
        run = lambda: t_prove(trace, flagship.DEMO_CONFIG, device=cuda)  # noqa: E731
    run()  # the builds and host tables outside the traces

    def kernels(events):
        return sorted(n for n, d in events if d == DeviceType.CUDA and not n.startswith(("Memcpy", "Memset")))

    with_spans = _traced_events(run)
    ours = [(n, d) for n, d in with_spans if n.startswith(spans.PREFIX)]
    assert ours and all(d != DeviceType.CUDA for _, d in ours)
    monkeypatch.setattr(spans, "_RecordFunctionFast", _NoRange)
    without = _traced_events(run)
    assert not any(n.startswith(spans.PREFIX) for n, _ in without)
    assert kernels(with_spans) == kernels(without)
