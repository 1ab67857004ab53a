"""The last-layer cell's pieces on the CPU (stwo_bench/): the plain
reference verifier of the Sha256MerkleChannel flavour against the port's
provers and the committed bitcoin proof, planted faults named by its
checks, the synthetic circuits' pinned digests, the frozen SHA-256 count,
the two new metrics' arithmetic, drivers/prove_np.py's run and its control, and the
reference's independence from both packages."""

import copy
import hashlib
import json
import os
import subprocess
import sys
from functools import lru_cache

import numpy as np
import pytest

from recursive_stwo_tpu_torch.models import flagship
from recursive_stwo_tpu_torch.proof.containers import FriConfig, PcsConfig
from recursive_stwo_tpu_torch.prover import flow as flow_mod
from recursive_stwo_tpu_torch.prover.commit import Sha256DeviceTree
from recursive_stwo_tpu_torch.prover import prove_np as prove_np_mod
from recursive_stwo_tpu_torch.prover import stream as stream_mod
from recursive_stwo_tpu_torch.prover.prove_np import prove_np
from recursive_stwo_tpu_torch.prover.prove_sha256 import Sha256ProverChannel
from recursive_stwo_tpu_torch.prover.stream import prove_np_streamed
from recursive_stwo_tpu_torch.utils.spans import PREFIX
from stwo_bench import control
from stwo_bench.harness import cell, circuit, circuit_np, registry, work_sha
from stwo_bench.harness import trace as trace_mod
from stwo_bench.reference import check_proof_np
from stwo_bench.reference.proof.parse_np import parse_plonk_without_poseidon_proof
from stwo_bench.reference.verifier import spec_np, stark_sha

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = (1 << 31) - 1
BENCH = registry.load_benchmark()
CONFIG = registry.config(BENCH, "last_layer")

# a small seeded circuit of 2^7 rows (no permutation: the real circuit's
# proof holds the reference's AIR to every gate)
SMALL = dict(log_size_plonk=7, public_inputs=12, pow_bits=10, log_last_layer_degree_bound=0,
             log_blowup_factor=1, n_queries=3)
SMALL_PCS = PcsConfig(SMALL["pow_bits"], FriConfig(0, 1, 3))
# the cell's configuration at the tests' size: two such traces, their digests pinned
TINY = dict(SMALL, synthetic_permutations=0, synthetic_padding_rows=8, traces=[
    {"name": "seed1", "seed": 1, "trace_sha256": "c05f65079c559329cf5484450ccab73131977ba72f3c8e4a2619be9ee5199568",
     "inputs_sha256": "467c5b19731bf873e21eb0437599955fde956c23f4953a41a2909d53756caba2"},
    {"name": "seed2", "seed": 2, "trace_sha256": "92cb55c262b9f44884da16cdd0d322e44ca5bcd906c58d34e83a9163a3d2131c",
     "inputs_sha256": "a26dac4c9d5a46a19f72b6d730a45b34b36190deed84fe3d543b86a91231b519"}])
TINY_TRAFFIC = {"driver": "prove_np", "chunk_log": 8, "cutoff": 3, "trace_proofs": 1}


@lru_cache(maxsize=None)
def _small():
    return circuit_np.seeded_trace(SMALL["log_size_plonk"], SMALL["public_inputs"], 5, 0, 8)


def _sha_flavour():
    return dict(channel=Sha256ProverChannel(), tree_cls=Sha256DeviceTree)


@lru_cache(maxsize=None)
def _small_proofs():
    """(prove_np's bytes, prove_np_streamed's bytes) of the small circuit."""
    trace, _ = _small()
    resident = prove_np(trace, SMALL_PCS, device="cpu", **_sha_flavour())
    streamed = prove_np_streamed(trace, SMALL_PCS, device="cpu", chunk_log=5, cutoff=3, **_sha_flavour())
    return flagship.proof_bytes(resident), flagship.proof_bytes(streamed)


def _verify(blob: bytes, config: dict, inputs):
    return stark_sha.verify_proof(spec_np.for_config(config), parse_plonk_without_poseidon_proof(blob), inputs)[0]


def test_port_provers_are_accepted_by_the_reference():
    """prove_np and prove_np_streamed (chunks of 2^5, cutoff 3) in the
    Sha256MerkleChannel flavour make the same bytes, every named check of
    the reference holds, and the committed columns are the trace's at the
    OODS point."""
    resident, streamed = _small_proofs()
    assert resident == streamed
    trace, inputs = _small()
    checks = _verify(resident, SMALL, inputs)
    assert set(checks) == set(stark_sha.check_names(spec_np.for_config(SMALL))) and all(checks.values())
    assert check_proof_np.check(resident, SMALL, trace, inputs) == {"failed_checks": 0, "trace_samples_off": 0}


@pytest.mark.parametrize("prover", ["prove_np", "prove_np_streamed"])
def test_np_provers_open_the_air_and_upload_spans(prover, monkeypatch):
    """Each without-Poseidon prover opens `prove.air` around the AIR columns
    and then `prove.upload` around their upload, once a proof, as the
    PlonkWithPoseidon provers do (arrays.trace_to_torch): the upload of
    prover/flow.py's `NoPoseidonAir`, which both run.  The flow's own
    `prove.interaction` and `prove.composition` follow, once each."""
    module = {"prove_np": prove_np_mod, "prove_np_streamed": stream_mod}[prover]
    opened, real = [], flow_mod.span

    def recorded(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(flow_mod, "span", recorded)
    getattr(module, prover)(_small()[0], SMALL_PCS, device="cpu", **_sha_flavour())
    assert [n for n in opened if n.startswith("prove.")] == ["prove.air", "prove.upload", "prove.interaction",
                                                             "prove.composition"]


# each fault: the named check it must fail, and the checks it cannot reach
# (a sample or the nonce is mixed into the channel, so every later draw moves)
FAULTS = {
    "sampled_value": ("composition", ["total_sum"]),
    "first_layer_witness": ("fri_first", ["pow", "total_sum", "composition", "tree0", "tree1", "tree2", "tree3"]),
    "inner_layer_sibling": ("fri_inner2", None),
    "nonce": ("pow", ["total_sum", "composition"]),
}


def _plant(blob: bytes, kind: str):
    """The parsed proof with one value of the kind moved."""
    proof = copy.deepcopy(parse_plonk_without_poseidon_proof(blob))
    sp = proof.stark_proof
    if kind == "sampled_value":
        sp.sampled_values[1][0][0, 0] = (int(sp.sampled_values[1][0][0, 0]) + 1) % P
    elif kind == "first_layer_witness":
        w = sp.fri_proof.first_layer.fri_witness
        w[0, 2] = (int(w[0, 2]) + 1) % P
    elif kind == "inner_layer_sibling":
        sp.fri_proof.inner_layers[2].decommitment.hash_witness[0, 7] ^= 1
    else:
        sp.proof_of_work = int(sp.proof_of_work) + 1
    return proof


@pytest.mark.parametrize("kind", list(FAULTS))
def test_planted_fault_is_the_reference_named_check(kind):
    named, untouched = FAULTS[kind]
    checks, _ = stark_sha.verify_proof(spec_np.for_config(SMALL), _plant(_small_proofs()[0], kind), _small()[1])
    assert not checks[named] and not checks["ok"]
    if untouched is None:
        assert [k for k, v in checks.items() if not v] == [named, "ok"]
    else:
        assert all(checks[k] for k in untouched)


@lru_cache(maxsize=None)
def _real():
    """(the real last-layer trace, its public inputs), as the cell builds them."""
    trace, _, inputs = flagship.last_layer_trace(flagship.sha_artifact("level14"))
    return trace, inputs


def test_reference_accepts_the_bitcoin_proof():
    with open(os.path.join(REPO, "examples", "data", "bitcoin_proof.bin"), "rb") as f:
        blob = f.read()
    entry = CONFIG["traces"][0]
    assert hashlib.sha256(blob).hexdigest() == entry["proof_sha256"]
    assert all(_verify(blob, CONFIG, flagship.bitcoin_inputs()).values())
    trace, inputs = _real()
    assert inputs == flagship.bitcoin_inputs()
    assert check_proof_np.check(blob, CONFIG, trace, inputs) == {"failed_checks": 0, "trace_samples_off": 0}
    other = circuit_np.seeded_trace(CONFIG["log_size_plonk"], 264, 1, CONFIG["synthetic_permutations"],
                                    CONFIG["synthetic_padding_rows"])[0]
    assert check_proof_np.check(blob, CONFIG, other, inputs)["trace_samples_off"] == 20


def test_last_layer_traces_are_pinned():
    """The configuration's three traces, built as the driver builds them,
    hash to their pinned digests, at the stated shape."""
    entries = CONFIG["traces"]
    assert [("seed" in e, "input_proof" in e) for e in entries] == [(False, True), (True, False), (True, False)]
    built = [_real()] + [circuit_np.seeded_trace(CONFIG["log_size_plonk"], CONFIG["public_inputs"], e["seed"],
                                                 CONFIG["synthetic_permutations"], CONFIG["synthetic_padding_rows"])
                         for e in entries[1:]]
    for entry, (trace, inputs) in zip(entries, built):
        assert circuit.digest(trace) == entry["trace_sha256"]
        assert circuit_np.inputs_digest(inputs) == entry["inputs_sha256"]
        assert len(trace["a_wire"]) == 1 << CONFIG["log_size_plonk"] and len(inputs) == CONFIG["public_inputs"]


def _counted_tree(depth: int, cols_by_log: dict, lowest: int, rng) -> int:
    """Compressions of a tree built by hashing every node's message, counted
    as SHA-256 pads each message into 64-byte blocks."""
    count, level = 0, None
    for L in range(depth, lowest - 1, -1):
        cols = rng.integers(0, P, (1 << L, cols_by_log.get(L, 0)), dtype=np.uint32)
        messages = [(b"" if level is None else level[2 * k] + level[2 * k + 1]) + cols[k].astype(">u4").tobytes()
                    for k in range(1 << L)]
        count += sum(len(m + b"\x80" + bytes((55 - len(m)) % 64) + bytes(8)) // 64 for m in messages)
        level = [hashlib.sha256(m).digest() for m in messages]
    return count


def test_sha_count_equals_a_brute_force_count():
    rng = np.random.default_rng(7)
    assert work_sha.tree_compressions(6, {6: 13, 4: 4}, 2) == _counted_tree(6, {6: 13, 4: 4}, 2, rng)
    spec = spec_np.for_config(dict(SMALL, log_size_plonk=3))
    m = spec.max_first_layer_log
    brute = sum(_counted_tree(spec.tree_max_domain_log[t], dict(spec.n_columns_per_log_size[t]), 2, rng)
                for t in range(4))
    brute += _counted_tree(m, {log: 4 for log in spec.all_log_sizes}, 2, rng)
    brute += sum(_counted_tree(m - 1 - i, {m - 1 - i: 4}, 2, rng) for i in range(spec.n_inner_layers))
    assert work_sha.prover_compressions(spec, 2) == brute
    assert work_sha.compression_seconds(10**9) == pytest.approx(10**9 * 2296 / (4 * 32 * 132 * 1.98e9))


class _Event:
    def __init__(self, name, start, dur, cuda):
        self._n, self._s, self._d, self._c = name, start, dur, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self._c else DeviceType.CPU


def test_new_metrics_arithmetic():
    events = [_Event("bench#prove", 0, 10_000, False),
              _Event("(anonymous namespace)::sha256_level_kernel(long const*)", 100, 2_000, True),
              _Event("(anonymous namespace)::sha256_level_kernel(long const*)", 3_000, 2_000, True),
              _Event("fri_layer_kernel", 6_000, 1_000, True),
              _Event(PREFIX + "fri.grind", 4_000, 3_000, False), _Event(PREFIX + "fri.grind", 8_000, 1_000, False)]
    tr = trace_mod.Trace(events)
    work = {"sha_compressions_per_proof": 1000}
    record = {"kind": "prove", "trace": tr, "units": 2, "work": work}
    sha = registry.reader("prove.sha_roofline")(record)
    assert sha == pytest.approx(100.0 * work_sha.compression_seconds(2000) / 4e-6)
    assert registry.reader("prove.grind_s")(record) == pytest.approx(4e-6 / 2)
    bare = trace_mod.Trace(events[:1] + events[3:4])
    assert registry.reader("prove.sha_roofline")(dict(record, trace=bare)) is None
    assert registry.reader("prove.grind_s")(dict(record, trace=bare)) is None
    assert registry.reader("prove.sha_roofline")(dict(record, work={"perms_per_proof": 5})) is None


def test_driver_run_and_its_control_on_the_cpu():
    """The cell's driver at the test size: a window's proof judged correct
    with every compared number 0, then at 8 PoW bits fewer (control.py's
    hook) not correct."""
    session = registry.driver("prove_np").Session(TINY, TINY_TRAFFIC, 2**31 + 11, "cpu")
    session.window(0.0, cell.Spans(False))
    verdict = session.judge()
    assert verdict["correct"] and verdict["compared"]["proofs_checked"]["value"] == 1
    assert all(c["value"] == 0 for k, c in verdict["compared"].items() if k != "proofs_checked")
    assert verdict["work"]["sha_compressions_per_proof"] == work_sha.prover_compressions(spec_np.for_config(TINY), 3)
    control.hook(session)
    session.window(0.0, cell.Spans(False))
    verdict = session.judge()
    assert not verdict["correct"] and verdict["compared"]["failed_checks"]["value"] > 0


def test_reference_imports_neither_package():
    """The new reference parses and verifies the bitcoin proof in a process
    that refuses JAX, the JAX package and the port."""
    inputs = json.dumps([[i, list(v)] for i, v in flagship.bitcoin_inputs()])
    code = f"""
import sys
class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.partition(".")[0] in ("jax", "jaxlib", "flax", "recursive_stwo_tpu", "recursive_stwo_tpu_torch"):
            raise ImportError(name + " is refused")
sys.meta_path.insert(0, Refuse())
sys.path.insert(0, {REPO!r})
from stwo_bench.reference import check_proof_np
from stwo_bench.reference.proof.parse_np import parse_plonk_without_poseidon_proof
from stwo_bench.reference.verifier import spec_np, stark_sha
from stwo_bench.harness import registry
config = registry.config(registry.load_benchmark(), "last_layer")
inputs = tuple((i, tuple(v)) for i, v in {inputs})
blob = open({os.path.join(REPO, 'examples', 'data', 'bitcoin_proof.bin')!r}, "rb").read()
checks, _ = stark_sha.verify_proof(spec_np.for_config(config), parse_plonk_without_poseidon_proof(blob), inputs)
assert all(checks.values()), checks
assert not [m for m in sys.modules if m.partition(".")[0] in ("jax", "recursive_stwo_tpu", "recursive_stwo_tpu_torch")]
print("REFERENCE-OK")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0 and "REFERENCE-OK" in out.stdout, out.stderr
