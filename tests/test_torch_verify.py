"""The port's whole verifier against the JAX package's host verifier
(verify.verify_batch on numpy ProofArrays) on the committed fixtures: every
named check and 'ok', per proof, with the same keys in the same order, for
clean and corrupted batches.  Tolerance 0.  Nothing here jits the JAX
verifier."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from recursive_stwo_tpu.verifier import verify as r_verify
from recursive_stwo_tpu_torch.models import flagship
from recursive_stwo_tpu_torch.verifier import verify as t_verify
from recursive_stwo_tpu_torch.verifier.arrays import to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _both(name, pa, inputs=None):
    """(reference checks, port checks) as {key: bool numpy array}."""
    spec, _ = flagship.prepared_arrays(name)
    inputs = inputs or flagship.FIXTURE_INPUTS[name]
    ref = r_verify.verify_batch(spec, pa, inputs)
    got = t_verify.verify_batch(spec, to_torch(pa, "cpu"), inputs)
    assert list(ref) == list(got)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = {k: v.numpy() for k, v in got.items()}
    for k in ref:
        assert got[k].dtype == bool and np.array_equal(ref[k], got[k]), k
    return got


def _batch(name, B):
    return flagship.tiled_batch(flagship.prepared_arrays(name)[1], B)


def _failing(checks, slot):
    return sorted(k for k, v in checks.items() if not v[slot])


@pytest.mark.parametrize("name,B", [("small_proof", 2), ("recursive_proof_16_15", 1)])
def test_clean_batch_matches_reference(name, B):
    checks = _both(name, _batch(name, B))
    assert all(v.shape == (B,) and v.all() for v in checks.values())


def test_corrupted_sibling_hash_fails_exactly_that_tree():
    pa = _batch("small_proof", 2)
    pa.tree_paths[1].sibling_hashes[1, 0, 0, 0] ^= np.uint32(1)
    checks = _both("small_proof", pa)
    assert _failing(checks, 0) == []
    assert _failing(checks, 1) == ["ok", "tree1"]


def test_nonce_flip_fails_pow():
    pa = _batch("small_proof", 2)
    pa.nonce_limbs[0] ^= np.uint32(1)
    checks = _both("small_proof", pa)
    assert not checks["pow"][0] and not checks["ok"][0] and checks["ok"][1]


def test_wrong_public_inputs_fail_total_sum():
    checks = _both("small_proof", _batch("small_proof", 2), ((1, (2, 0, 0, 0)),))
    assert not checks["total_sum"].any() and not checks["ok"].any()
    assert checks["composition"].all() and checks["tree0"].all()


def test_verifier_step_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        flagship.verifier_step("small_proof", 1, device="cuda")


# Run in a subprocess: refuse every import of jax and of the JAX package,
# then import each module of the port.
BLOCKED_PREAMBLE = (
    "import importlib, importlib.abc, pkgutil, sys\n"
    "class Refuse(importlib.abc.MetaPathFinder):\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.partition('.')[0] in ('jax', 'jaxlib', 'recursive_stwo_tpu'):\n"
    "            raise ImportError('refused: ' + name)\n"
    "sys.meta_path.insert(0, Refuse())\n"
    "import recursive_stwo_tpu_torch\n"
    "for m in pkgutil.walk_packages(recursive_stwo_tpu_torch.__path__, 'recursive_stwo_tpu_torch.'):\n"
    "    importlib.import_module(m.name)\n"
)


def run_blocked(code: str) -> None:
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", BLOCKED_PREAMBLE + code + "print('BLOCKED-OK')\n"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "BLOCKED-OK" in out.stdout


def test_port_never_imports_jax():
    """Every port module imports, and the CPU verifier runs, with jax and
    the JAX package refused."""
    run_blocked(
        "from recursive_stwo_tpu_torch.models import flagship\n"
        "step, arrays = flagship.verifier_step('small_proof', 2, device='cpu')\n"
        "assert bool(step(arrays)['ok'].all())\n"
    )


def test_other_flavours_never_import_jax():
    """verify_batch_np, both host SHA-256 verifiers and device_checks_np
    run on the CPU with jax and the JAX package refused."""
    run_blocked(
        "from recursive_stwo_tpu_torch.models import flagship\n"
        "from recursive_stwo_tpu_torch.verifier import verify_sha256_host as vh\n"
        "step, arrays = flagship.verifier_step_np('np_small', 2, device='cpu')\n"
        "assert bool(step(arrays)['ok'].all())\n"
        "level14, bitcoin = flagship.sha_artifacts()\n"
        "assert vh.verify_sha256p31_host(level14, flagship.CHAIN_INPUTS)['ok'].all()\n"
        "assert vh.verify_sha256np_host(bitcoin, flagship.bitcoin_inputs())['ok'].all()\n"
        "step, arrays, fs = flagship.sha_checks_step('bitcoin', 2, device='cpu')\n"
        "assert bool(step(arrays, fs)['ok'].all())\n"
    )


def _imported_roots(path: str):
    """Top-level package of every import statement in a source file, with
    the module it names."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("part", ["verifier", "prover"])
def test_sources_import_neither_jax_nor_the_jax_package(part):
    """An ast scan: no import of jax or of recursive_stwo_tpu (other than
    the port itself) in any source of the port, or in chip_smoke.py.  The
    prover part is prover/ and tools/; the verifier part is the rest."""
    pkg = os.path.join(REPO, "recursive_stwo_tpu_torch")
    files = [os.path.join(REPO, "chip_smoke.py")] if part == "verifier" else []
    for root, _, names in os.walk(pkg):
        sub = os.path.relpath(root, pkg).split(os.sep)[0]
        if (sub in ("prover", "tools")) == (part == "prover"):
            files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for path in files:
        for mod in _imported_roots(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "recursive_stwo_tpu"), f"{path} imports {mod}"
