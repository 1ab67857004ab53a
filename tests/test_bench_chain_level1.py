"""The level-1 chain cell's pieces on the CPU (stwo_bench/): the port's
resident prover at a `fast_prover`-shaped configuration (blowup 1, 80
queries) held to the plain reference verifier, planted faults named by its
checks, the committed level1-5 proof accepted against the real level-1
circuit, the configuration's pinned digests checked at set-up,
drivers/prove_chain.py's run and its control, the two new metrics'
arithmetic, and the driver's run with JAX and the JAX package refused."""

import copy
import hashlib
import os
import subprocess
import sys
from functools import lru_cache

import pytest

from recursive_stwo_tpu_torch.models import flagship
from recursive_stwo_tpu_torch.proof.containers import FriConfig, PcsConfig
from recursive_stwo_tpu_torch.prover.prove import prove
from stwo_bench import control
from stwo_bench.harness import cell, circuit, registry
from stwo_bench.harness.work import prover_perms
from stwo_bench.reference import check_proof
from stwo_bench.reference import config as ref_config
from stwo_bench.reference.proof.parse import parse_plonk_with_poseidon_proof
from stwo_bench.reference.verifier import stark

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = (1 << 31) - 1
BENCH = registry.load_benchmark()
CONFIG = registry.config(BENCH, "chain_level1")

# fast_prover's FRI (blowup 1, 80 queries) at the smallest tables the seeded
# circuit makes (2^8 / 2^8 rows: first-layer groups at 2^11 and 2^9, so 80
# queries collide); bound 7, not 8, since every group must lie above the
# last layer's domain, as level 1's (2^21, 2^20, 2^19 over 2^9) do
TINY = dict(log_size_plonk=8, log_size_poseidon=8, pow_bits=10, log_last_layer_degree_bound=7,
            log_blowup_factor=1, n_queries=80, public_inputs=CONFIG["public_inputs"], traces=[
                {"name": "seed1", "seed": 1,
                 "trace_sha256": "535f8089a8e5c6d2ebefd8bda6cfccce37c25f9e8800c96fa2aec4fb43161460"},
                {"name": "seed2", "seed": 2,
                 "trace_sha256": "fe02b963cf1d57bf773f8847eead1bdfea17a783699e965f00e14b03e74d9f88"}])
TINY_PCS = PcsConfig(TINY["pow_bits"], FriConfig(7, 1, 80))
TINY_TRAFFIC = {"driver": "prove_chain", "path": "resident", "trace_proofs": 2}


@lru_cache(maxsize=None)
def _tiny_trace(seed: int = 1):
    return circuit.seeded_trace(TINY["log_size_plonk"], TINY["log_size_poseidon"], circuit.trace_rng(seed, 0))


@lru_cache(maxsize=None)
def _tiny_proof() -> bytes:
    return flagship.proof_bytes(prove(_tiny_trace(), TINY_PCS, device="cpu"))


def _checks(proof, config: dict) -> dict:
    """The reference's named checks of a parsed proof."""
    return stark.verify_proof(ref_config.spec(config), proof, ref_config.public_inputs(config))[0]


def test_port_proof_is_accepted_by_the_reference():
    """Every named check of the reference holds on the port's proof at 80
    queries and blowup 1, the committed columns are the trace's at the OODS
    point, and the same proof held to another trace is off in every column
    tied to it."""
    blob = _tiny_proof()
    checks = _checks(parse_plonk_with_poseidon_proof(blob), TINY)
    assert set(checks) == set(stark.check_names(ref_config.spec(TINY))) and all(checks.values())
    assert check_proof.check(blob, TINY, _tiny_trace()) == {"failed_checks": 0, "trace_samples_off": 0}
    other = check_proof.check(blob, TINY, _tiny_trace(2))
    assert other == {"failed_checks": 0, "trace_samples_off": len(check_proof.PLONK_VALUE_COLUMNS)
                     + len(check_proof.POSEIDON_COLUMNS)}


# each fault: the named check it must fail, and the checks it cannot reach
# (a sample is mixed into the channel, so every later draw moves)
FAULTS = {
    "sampled_value": ("composition", ["total_sum"]),
    "first_layer_witness": ("fri_first", ["pow", "total_sum", "composition", "tree0", "tree1", "tree2", "tree3"]),
    "trace_decommitment": ("tree1", None),
    "inner_layer_sibling": ("fri_inner0", None),
}


def _plant(blob: bytes, kind: str):
    """The parsed proof with one value of the kind moved."""
    proof = copy.deepcopy(parse_plonk_with_poseidon_proof(blob))
    sp = proof.stark_proof
    if kind == "sampled_value":
        sp.sampled_values[1][0][0, 0] = (int(sp.sampled_values[1][0][0, 0]) + 1) % P
    elif kind == "first_layer_witness":
        w = sp.fri_proof.first_layer.fri_witness
        w[0, 2] = (int(w[0, 2]) + 1) % P
    elif kind == "trace_decommitment":
        h = sp.decommitments[1].hash_witness
        h[0, 3] = (int(h[0, 3]) + 1) % P
    else:
        h = sp.fri_proof.inner_layers[0].decommitment.hash_witness
        h[0, 7] = (int(h[0, 7]) + 1) % P
    return proof


@pytest.mark.parametrize("kind", list(FAULTS))
def test_planted_fault_is_the_reference_named_check(kind):
    named, untouched = FAULTS[kind]
    checks = _checks(_plant(_tiny_proof(), kind), TINY)
    assert not checks[named] and not checks["ok"]
    if untouched is None:
        assert [k for k, v in checks.items() if not v] == [named, "ok"]
    else:
        assert all(checks[k] for k in untouched)


@lru_cache(maxsize=None)
def _level1_trace():
    return flagship.chain_level_trace(1)[0]


def test_reference_accepts_the_level1_artifact():
    """The committed level1-5 proof's bytes are level1-5.bin's (the digest of
    docs/chain_artifacts.txt and of the configuration), and the reference
    accepts them under the configuration's PcsConfig against the real
    level-1 circuit, whose digest the configuration pins."""
    entry = CONFIG["traces"][0]
    blob = flagship.proof_bytes(flagship.load_artifact(os.path.join(REPO, entry["proof"])))
    assert hashlib.sha256(blob).hexdigest() == entry["proof_sha256"] == flagship.expected_sha256("level1-5")
    trace = _level1_trace()
    assert circuit.digest(trace) == entry["trace_sha256"]
    assert check_proof.check(blob, CONFIG, trace) == {"failed_checks": 0, "trace_samples_off": 0}


def test_level1_configuration_is_the_chain_level():
    """The configuration states level 1's shape and preset (CHAIN_LEVELS,
    docs/chain_log.jsonl), its input's digest, and two fixed synthetic
    traces of the shape, each pinned."""
    inp, multipliers, out, pcs = flagship.CHAIN_LEVELS[1]
    entries = CONFIG["traces"]
    assert [("seed" in e, "input_proof" in e) for e in entries] == [(False, True), (True, False), (True, False)]
    assert (entries[0]["level"], entries[0]["multipliers"]) == (1, multipliers) and out in entries[0]["proof"]
    assert inp in entries[0]["input_proof"]
    assert ref_config.pcs_config(CONFIG) == ref_config.pcs_config(dict(
        pow_bits=pcs.pow_bits, log_last_layer_degree_bound=pcs.fri_config.log_last_layer_degree_bound,
        log_blowup_factor=pcs.fri_config.log_blowup_factor, n_queries=pcs.fri_config.n_queries))
    with open(os.path.join(REPO, entries[0]["input_proof"]), "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == entries[0]["input_proof_sha256"]
    spec = ref_config.spec(CONFIG)
    assert (spec.log_size_plonk, spec.log_size_poseidon, spec.max_first_layer_log) == (19, 18, 21)
    for entry in entries[1:]:
        trace = circuit.seeded_trace(19, 18, circuit.trace_rng(entry["seed"], 0))
        assert circuit.digest(trace) == entry["trace_sha256"]


def _real_entry(**changed) -> dict:
    return dict(CONFIG, traces=[dict(CONFIG["traces"][0], **changed)])


@pytest.mark.parametrize("config,message", [
    (dict(TINY, traces=[dict(TINY["traces"][0], trace_sha256="0" * 64)]), "trace seed1 hashes to"),
    (_real_entry(input_proof_sha256="0" * 64), "recursive_proof_16_15.bin hashes to"),
    (_real_entry(proof_pkl_sha256="0" * 64), "level1-5.pkl hashes to"),
    (_real_entry(proof_sha256="0" * 64), "proof bytes hash to"),
    (_real_entry(multipliers=4), "verifies its input 5 times"),
], ids=["trace", "input_proof", "artifact_file", "artifact_bytes", "multipliers"])
def test_wrong_pin_fails_the_setup(config, message):
    """A pinned digest that does not match, or a circuit other than the chain
    level's, stops the set-up before any proof."""
    with pytest.raises(RuntimeError, match=message):
        registry.driver("prove_chain").Session(config, TINY_TRAFFIC, 5, "cpu")


def test_driver_run_and_its_control_on_the_cpu():
    """The cell's driver at the test size: a window's proof judged correct
    with every compared number 0 (trace 0 held to its proof's bytes as the
    real circuit is held to its artifact), then with those bytes moved, and
    at 8 PoW bits fewer (control.py's hook), not correct."""
    session = registry.driver("prove_chain").Session(TINY, TINY_TRAFFIC, 2**31 + 11, "cpu")
    session.expected = {0: _tiny_proof()}
    session.window(0.0, cell.Spans(False))
    verdict = session.judge()
    assert verdict["correct"] and verdict["compared"]["proofs_checked"]["value"] == 1
    assert list(verdict["compared"]) == ["proofs_checked", "failed_checks", "trace_samples_off",
                                         "traces_with_two_proofs", "artifact_mismatch"]
    assert all(c["value"] == 0 for k, c in verdict["compared"].items() if k != "proofs_checked")
    assert verdict["work"]["perms_per_proof"] == prover_perms(ref_config.spec(TINY))
    session.expected = {0: _tiny_proof()[:-1] + bytes([_tiny_proof()[-1] ^ 1])}
    session.window(0.0, cell.Spans(False))
    verdict = session.judge()
    assert not verdict["correct"] and verdict["compared"]["artifact_mismatch"]["value"] == 1
    assert verdict["compared"]["failed_checks"]["value"] == 0
    session.expected = {}
    control.hook(session)
    session.window(0.0, cell.Spans(False))
    verdict = session.judge()
    assert not verdict["correct"] and verdict["compared"]["failed_checks"]["value"] > 0


def _record(stages):
    return {"kind": "prove", "stages": stages}


def _proof_stages(upload=0.5, interaction=0.25, composition=0.125):
    return [("trace uploaded (log sizes 19/18, composition bound 20)", upload),
            ("tree0 (preprocessed) committed", 1.0), ("tree1 (trace) committed", 1.0),
            ("interaction columns generated", interaction), ("tree2 (interaction) committed", 1.0),
            ("composition coefficients computed", composition), ("tree3 (composition) committed", 1.0)]


def test_new_metrics_arithmetic():
    upload, constraints = registry.reader("prove.upload_s"), registry.reader("prove.constraints_s")
    stages = [_proof_stages(), _proof_stages(0.25, 0.5, 0.5)]
    assert upload(_record(stages)) == pytest.approx((0.5 + 0.25) / 2)
    assert constraints(_record(stages)) == pytest.approx((0.375 + 1.0) / 2)
    # a proof without the stage leaves the metric out, as does a record of no stages or of a verifier
    no_upload = [_proof_stages(), _proof_stages()[1:]]
    no_composition = [_proof_stages(), [s for s in _proof_stages() if not s[0].startswith("composition")]]
    assert upload(_record(no_upload)) is None and constraints(_record(no_upload)) is not None
    assert constraints(_record(no_composition)) is None and upload(_record(no_composition)) is not None
    for record in (_record([]), {"kind": "prove"}, {"kind": "verify", "stages": stages}):
        assert upload(record) is None and constraints(record) is None


def test_driver_runs_with_jax_refused():
    """The driver's set-up, window and judge at the test size in a process
    that refuses JAX and the JAX package, which the run never loads."""
    code = f"""
import sys
class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.partition(".")[0] in ("jax", "jaxlib", "flax", "recursive_stwo_tpu"):
            raise ImportError(name + " is refused")
sys.meta_path.insert(0, Refuse())
sys.path.insert(0, {REPO!r})
import torch
torch.set_num_threads(2)
from stwo_bench.harness import cell, guard, registry
config = {TINY!r}
session = registry.driver("prove_chain").Session(config, {TINY_TRAFFIC!r}, 3, "cpu")
session.window(0.0, cell.Spans(False))
assert session.judge()["correct"]
assert not guard.forbidden_loaded(), guard.forbidden_loaded()
print("DRIVER-OK")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0 and "DRIVER-OK" in out.stdout, out.stderr
