"""The comparison that decides `correct`, shown to fail: the control (the
timed path with one stated guarantee broken) and a fault planted in the
timed path under the harness each come out not correct, at a size a CPU
test run can hold.  The control's readings at the cells' own sizes come
from stwo_bench/control.py on the card."""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest

import bench_copy

sys.path.insert(0, bench_copy.ROOT)


@pytest.fixture(scope="module")
def copy_root(tmp_path_factory):
    root = bench_copy.make_copy(str(tmp_path_factory.mktemp("bench")))
    with open(os.path.join(root, "stwo_bench", "tests", "control_hook.py"), "w") as f:
        f.write("import sys\nsys.path.insert(0, %r)\nimport control\nhook = control.hook\n"
                % os.path.join(root, "stwo_bench"))
    return root


@pytest.mark.parametrize("cell", ["tiny.verify", "tiny.prove"])
def test_control_is_not_correct(copy_root, cell):
    out = bench_copy.run_cpu(copy_root, cell, fault="control", seconds=0.01)
    assert out["correct"] is False
    compared = out["compared"]
    assert compared.get("checks_differing", {}).get("value", 0) > 0 or compared["failed_checks"]["value"] > 0


@pytest.mark.parametrize("fault,cell,seconds", [
    ("verify:stale", "tiny.verify", 0.01),
    ("verify:half", "tiny.verify", 0.01),
    ("verify:altered", "tiny.verify", 0.01),
    ("verify:hints", "tiny.verify", 0.01),
    ("prove:stale", "tiny.prove", 20.0),
    ("prove:altered", "tiny.prove", 0.01),
    ("prove:altered", "tiny.prove_streamed", 0.01),
])
def test_fault_is_not_correct(copy_root, fault, cell, seconds):
    out = bench_copy.run_cpu(copy_root, cell, fault=fault, seconds=seconds)
    assert out["correct"] is False


def test_sound_runs_read_zero(copy_root):
    out = bench_copy.run_cpu(copy_root, "tiny.prove", seed=2**31 + 3, seconds=8.0)
    assert out["correct"] is True and out["attempted"] >= 1
    assert out["compared"]["trace_samples_off"]["value"] == 0
    assert out["compared"]["failed_checks"]["value"] == 0


def test_proof_check_tells_traces_apart():
    from stwo_bench.harness import circuit
    from stwo_bench.reference import check_proof

    def rows(seed):
        return circuit.seeded_trace(8, 8, circuit.trace_rng(seed, 0))

    coeffs = np.random.default_rng(1).integers(0, (1 << 31) - 1, (3, 16)).astype(np.uint32)
    from stwo_bench.reference.core import qm31_host as q
    from stwo_bench.reference.prover.circle_fft_host import eval_at_point

    px, py = q.q_scalar(5, 6, 7, 8), q.q_scalar(9, 10, 11, 12)
    want = [eval_at_point(np.stack([c, 0 * c, 0 * c, 0 * c], axis=-1), px, py) for c in coeffs]
    got = check_proof.eval_at(coeffs, q.QM31(*(np.array([v]) for v in px)), q.QM31(*(np.array([v]) for v in py)))
    assert [tuple(int(v) for v in row) for row in got] == want
    assert circuit.digest(rows(1)) != circuit.digest(rows(2))


def test_proof_check_ties_both_tables():
    """A proof held to another trace of the same shape reads every tied
    column off, the poseidon table's as well as the plonk table's."""
    import json

    from stwo_bench.harness import circuit
    from stwo_bench.reference import check_proof, config as ref_config
    from recursive_stwo_tpu_torch.models.flagship import proof_bytes
    from recursive_stwo_tpu_torch.prover.prove import prove

    with open(os.path.join(bench_copy.DATA, "tiny_chain.json")) as f:
        config = json.load(f)
    lp, lq = config["log_size_plonk"], config["log_size_poseidon"]
    mine, other = (circuit.seeded_trace(lp, lq, circuit.trace_rng(2**31 + 21, i)) for i in range(2))
    blob = proof_bytes(prove(mine, ref_config.pcs_config(config), None, "cpu"))
    assert check_proof.check(blob, config, mine) == {"failed_checks": 0, "trace_samples_off": 0}
    got = check_proof.check(blob, config, other)
    n_tied = len(check_proof.PLONK_VALUE_COLUMNS) + len(check_proof.POSEIDON_COLUMNS)
    assert got == {"failed_checks": 0, "trace_samples_off": n_tied}
