"""chip_smoke.py: what a CPU can check (refusals, the result line, the
compile-cache location, every phase at toy sizes), and the GPU run itself
under the ``gpu`` marker."""
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import scipy.sparse as sp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def _run_script(path, cwd, timeout=240, extra_env=None):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(extra_env or {})
    return subprocess.run([sys.executable, path], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _last_json(stdout):
    lines = stdout.strip().splitlines()
    if not lines:
        return None
    try:
        return json.loads(lines[-1])
    except json.JSONDecodeError:
        return None


def test_refuses_cpu_device(tmp_path):
    p = _run_script(SCRIPT, str(tmp_path),
                    extra_env={"JAX_PLATFORMS": "cpu"})
    assert p.returncode != 0
    assert _last_json(p.stdout) is None
    assert "no GPU" in p.stderr


def test_refuses_without_the_repo(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(SCRIPT, lone)
    p = _run_script(str(lone), str(tmp_path),
                    extra_env={"JAX_PLATFORMS": "cpu"})
    assert p.returncode != 0
    assert _last_json(p.stdout) is None


def test_result_line_is_exactly_the_contract():
    line = cs.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert "\n" not in line


@pytest.fixture
def _restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_defaults_to_checkout(monkeypatch, _restore_cache_dir):
    from cgx.utils.compile_cache import REPO_CACHE_DIR, enable_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert REPO_CACHE_DIR == os.path.join(REPO, ".cache", "jax")
    assert enable_compile_cache() == REPO_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == REPO_CACHE_DIR


def test_compile_cache_follows_environment(monkeypatch, tmp_path,
                                           _restore_cache_dir):
    from cgx.utils.compile_cache import enable_compile_cache

    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; nothing is set in code.
    assert jax.config.jax_compilation_cache_dir is None


def test_dia_matvec64_matches_scipy(rng):
    from cgx.io.poisson import poisson3d_dia27

    d = poisson3d_dia27(4, 3, 5, variable=True, dtype=np.float64)
    data = np.asarray(d.data)
    n = d.shape[0]
    a = sp.dia_matrix((np.stack([np.roll(data[k], off) for k, off in
                                 enumerate(d.offsets)]), d.offsets),
                      shape=(n, n))
    x = rng.standard_normal(n)
    np.testing.assert_allclose(cs.dia_matvec64(data, d.offsets, x), a @ x,
                               rtol=1e-13, atol=1e-13)


def test_check_raises_phase_failed():
    with pytest.raises(cs.PhaseFailed, match="boom"):
        cs.check(False, "boom")


# Every phase at toy sizes on the CPU: the control flow, the references
# and the checks (timings printed here are CPU times and mean nothing).

def test_phase_structured_and_trace_on_cpu():
    s = cs.phase_structured(side=12)
    assert s["iterations"] > 0
    # The CPU has no device plane: the trace check refuses it.
    with pytest.raises(cs.PhaseFailed, match="no device events"):
        cs.phase_trace(s)


def test_spmv_and_cg_rates_on_cpu():
    # 64³: large enough that each differenced loop outlasts the CPU's
    # timing noise (a 10³ copy loop does not).
    rates = cs.spmv_rates(side=64)
    assert set(rates) == {"stencil_64", "stencil_63", "copy_64", "copy_63",
                          "dia_64"}
    assert all(t > 0 and bw > 0 for t, bw in rates.values())
    assert cs.cg_stencil_rate(side=10) > 0


def test_phase_unstructured_on_cpu():
    out = cs.phase_unstructured(scale=0.003)
    assert set(out) == {"jacobi", "ic0", "fp32_jacobi", "fp32_ic0"}
    assert out["ic0"][0] < out["jacobi"][0]
    assert out["fp32_ic0"][0] < out["fp32_jacobi"][0]


def test_phase_accuracy_on_cpu():
    assert cs.phase_accuracy(scale=0.1) <= cs.DF64_TRUE_BOUND


def test_phase_multi_rhs_on_cpu():
    out = cs.phase_multi_rhs(side=10, k=4)
    assert set(out) == {"multi", "block"}


def test_phase_resume_on_cpu():
    assert cs.phase_resume(side=10, chunk=10)


def test_phase_scipy_on_cpu():
    assert cs.phase_scipy(side=12) <= cs.SCIPY_REL_ERR_BOUND


def test_phase_sharded_on_four_cpu_devices():
    cs.phase_sharded(4, dims=(8, 6, 5))


@pytest.fixture
def gpu_present():
    """Skip unless nvidia-smi lists a GPU.  Decided here, at run time; the
    test process itself stays on the CPU, and the smoke run gets the card
    in its own process."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        pytest.skip("no nvidia-smi: not a GPU machine")
    p = subprocess.run([smi, "-L"], capture_output=True, text=True)
    if p.returncode != 0 or "GPU" not in p.stdout:
        pytest.skip("nvidia-smi lists no GPU")


@pytest.mark.gpu
def test_chip_smoke_passes_on_the_gpu(gpu_present, tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    p = subprocess.run([sys.executable, SCRIPT], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    last = _last_json(p.stdout)
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
