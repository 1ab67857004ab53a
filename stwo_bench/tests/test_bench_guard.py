"""The import guard: the harness's CPU path runs with JAX and the JAX
package refused, and the reference imports nothing of JAX, of the JAX
package or of the program (top-level names compared whole: the program's
name begins with the JAX package's)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

import bench_copy


def _loaded(code: str) -> list:
    script = ("import sys, json; sys.path.insert(0, sys.argv[1]); sys.path.insert(0, sys.argv[2]); "
              "import blocker; blocker.install(); " + code +
              "; print(json.dumps(sorted({m.partition('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", script, f"{bench_copy.BENCH}/tests", bench_copy.ROOT],
                         capture_output=True, text=True, check=True, timeout=300)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_reference_imports_nothing_of_jax_or_the_program():
    code = ("from stwo_bench.reference import check_verify, check_proof, config; "
            "from stwo_bench.harness import corrupt, work, stats")
    top = _loaded(code)
    assert not {"jax", "jaxlib", "flax", "recursive_stwo_tpu", "recursive_stwo_tpu_torch"} & set(top)


def test_harness_and_drivers_load_without_jax():
    code = ("from stwo_bench.harness import registry, cell; "
            "b = registry.load_benchmark(); "
            "[registry.driver(registry.traffic(w['traffic'])['driver']) for w in b['workloads']]; "
            "[registry.reader(m['name']) for m in b['end_to_end'] + b['per_layer']]")
    top = _loaded(code)
    assert not {"jax", "jaxlib", "flax", "recursive_stwo_tpu"} & set(top)


@pytest.fixture(scope="module")
def copy_root(tmp_path_factory):
    return bench_copy.make_copy(str(tmp_path_factory.mktemp("bench")))


def test_a_cpu_run_loads_no_jax(copy_root):
    out = bench_copy.run_cpu(copy_root, "tiny.verify", seed=2**31 + 11)
    assert out["correct"] is True and out["forbidden"] == []


def test_the_guard_compares_whole_names():
    sys.path.insert(0, bench_copy.ROOT)
    from stwo_bench.harness import guard

    assert guard.forbidden_loaded(["recursive_stwo_tpu_torch", "recursive_stwo_tpu_torch.ops", "torch"]) == []
    assert guard.forbidden_loaded(["recursive_stwo_tpu.verifier", "jax.numpy", "jaxlib"]) == [
        "jax", "jaxlib", "recursive_stwo_tpu"]
    assert json.loads(json.dumps(guard.FORBIDDEN))
