"""CLI tests (golden-file style, SURVEY.md §4.5) — all on CPU."""
import json
import subprocess
import sys

import numpy as np
import pytest

from cgx.cli import main


def run_cli(argv, capsys):
    code = main(argv)
    out, err = capsys.readouterr()
    return code, out, err


def test_gen_and_solve_legacy_roundtrip(tmp_path, capsys):
    p = str(tmp_path / "prob.txt")
    code, out, err = run_cli(["gen", "--poisson", "8x8", "--out", p], capsys)
    assert code == 0 and "n=64" in err

    code, out, err = run_cli(
        ["solve", "--input", p, "--dtype", "f64", "--tol", "1e-8",
         "--precond", "jacobi"], capsys)
    assert code == 0
    assert "converged=True" in err


def test_solve_legacy_compat_output_format(tmp_path, capsys):
    p = str(tmp_path / "prob.txt")
    run_cli(["gen", "--poisson", "5x5", "--out", p], capsys)
    code, out, err = run_cli(
        ["solve", "--input", p, "--dtype", "f64", "--maxiter", "30",
         "--legacy-compat"], capsys)
    assert code == 0
    lines = out.splitlines()
    assert len(lines) == 25
    assert all(l.startswith("\t") for l in lines)
    float(lines[0])  # parses as %f


def test_bench_json_line(capsys):
    code, out, err = run_cli(
        ["bench", "--poisson", "16x16", "--format", "dia", "--dtype", "f64",
         "--precond", "jacobi", "--reps", "2"], capsys)
    assert code == 0
    rec = json.loads(out.strip())
    assert rec["n"] == 256 and rec["converged"]
    assert rec["spmv_gnnz_s"] > 0


def test_solve_distributed(capsys):
    code, out, err = run_cli(
        ["solve", "--poisson", "16x16", "--format", "dia", "--dtype", "f64",
         "--precond", "jacobi", "--devices", "8", "--tol", "1e-8"], capsys)
    assert code == 0
    assert "converged=True" in err


def test_mtx_input(tmp_path, capsys):
    p = str(tmp_path / "a.mtx")
    code, out, err = run_cli(["gen", "--poisson", "7x6", "--out", p], capsys)
    assert code == 0
    code, out, err = run_cli(
        ["solve", "--input", p, "--dtype", "f64", "--tol", "1e-8"], capsys)
    assert code == 0 and "converged=True" in err


def test_print_sparse_format(capsys):
    import jax.numpy as jnp
    from cgx.utils.debug import format_sparse
    from cgx.io.poisson import poisson2d
    s = format_sparse(jnp.asarray([1.5, 0.0, -2.25]))
    lines = s.splitlines()
    assert lines[0] == "Size: 3" and lines[1] == "NNZ: 2"
    assert lines[2] == "\t1.500000"
    a = poisson2d(3, 3)
    s2 = format_sparse(a, max_entries=4)
    assert "Size: 9" in s2 and "more)" in s2


def test_solve_stencil_format(capsys):
    code, out, err = run_cli(
        ["solve", "--poisson", "8x8x8", "--format", "stencil",
         "--dtype", "f32", "--tol", "1e-5"], capsys)
    assert code == 0 and "converged=True" in err


def test_native_format_roundtrip(tmp_path, rng):
    import jax.numpy as jnp
    from cgx.io.native_format import save_matrix, load_matrix
    from cgx.io.poisson import poisson2d, poisson2d_dia
    from cgx.sparse.types import bsr_from_csr, ell_from_csr
    from cgx.sparse.stencil import poisson3d_stencil
    from cgx.ops.spmv import spmv
    import numpy as np

    a_csr = poisson2d(7, 6)
    b = rng.standard_normal(42)
    cases = {
        "csr": a_csr,
        "coo": a_csr.to_coo(),
        "dia": poisson2d_dia(7, 6),
        "ell": ell_from_csr(a_csr),
        "bsr": bsr_from_csr(a_csr, 4),
        "st3": poisson3d_stencil(3, 4, 5),
    }
    for name, a in cases.items():
        p = str(tmp_path / f"{name}.npz")
        save_matrix(p, a, b if name == "csr" else None)
        a2, b2 = load_matrix(p)
        n = min(a.shape[0], 42)
        x = jnp.asarray(rng.standard_normal(a.shape[0]),
                        jnp.asarray(0.0, dtype=a2.dtype).dtype
                        if hasattr(a2, "dtype") else None)
        x = jnp.asarray(np.asarray(x), dtype=None)
        y1 = np.asarray(spmv(a, x.astype(a.dtype)))
        y2 = np.asarray(spmv(a2, x.astype(a2.dtype)))
        np.testing.assert_allclose(y1, y2, rtol=1e-6, err_msg=name)
        if name == "csr":
            np.testing.assert_allclose(np.asarray(b2), b)


def test_bench_json_reports_path(capsys):
    """`cgx bench` routes through auto_solve and reports the operator
    format and the device it ran on."""
    code, out, err = run_cli(
        ["bench", "--poisson", "16x16", "--format", "dia", "--dtype", "f64",
         "--precond", "jacobi", "--reps", "1"], capsys)
    assert code == 0
    rec = json.loads(out.strip())
    assert rec["format"] == "DIAMatrix" and rec["device"] == "cpu"


def test_solve_distributed_method_flag(capsys):
    """--method single_reduction reaches the Chronopoulos-Gear path."""
    code, out, err = run_cli(
        ["solve", "--poisson", "16x16", "--format", "dia", "--dtype", "f64",
         "--precond", "jacobi", "--devices", "8", "--tol", "1e-8",
         "--method", "single_reduction"], capsys)
    assert code == 0
    assert "converged=True" in err


def test_solve_distributed_ic0_sweep(capsys):
    """--devices>1 --precond ic0-sweep routes the Schwarz block-IC(0)."""
    code, out, err = run_cli(
        ["solve", "--poisson", "16x16", "--format", "dia", "--dtype", "f64",
         "--precond", "ic0-sweep", "--sweeps", "2", "--devices", "8",
         "--tol", "1e-8"], capsys)
    assert code == 0
    assert "converged=True" in err


def test_solve_ic0_sweep_single_device(capsys):
    code, out, err = run_cli(
        ["solve", "--poisson", "12x12", "--dtype", "f64",
         "--precond", "ic0-sweep", "--tol", "1e-8"], capsys)
    assert code == 0
    assert "converged=True" in err


def test_solve_accuracy_df64(tmp_path, capsys):
    """--accuracy df64 routes the iterative-refinement path and reports
    the TRUE df64 relative residual."""
    p = str(tmp_path / "prob.txt")
    run_cli(["gen", "--poisson", "8x8", "--out", p], capsys)
    code, out, err = run_cli(
        ["solve", "--input", p, "--tol", "1e-6", "--precond", "jacobi",
         "--accuracy", "df64"], capsys)
    assert code == 0
    assert "df64 outer cycles=" in err
    assert "true_relres=" in err
    assert "converged=True" in err


def test_solve_format_auto_reports_pick(tmp_path, capsys):
    p = str(tmp_path / "prob.txt")
    run_cli(["gen", "--poisson", "10x10", "--out", p], capsys)
    code, out, err = run_cli(
        ["solve", "--input", p, "--format", "auto", "--tol", "1e-6"],
        capsys)
    assert code == 0, err
    assert "format=" in err            # the picked format is reported
    assert "converged=True" in err


def test_solve_file_input_defaults_to_auto_format(tmp_path, capsys):
    """No --format flag + a file input → the auto pick runs and is
    reported (the reference-class user — `cg <file> <iters>`,
    cg.c:42-85 — gets a storage pick with no extra flags)."""
    p = str(tmp_path / "prob.txt")
    run_cli(["gen", "--poisson", "10x10", "--out", p], capsys)
    code, out, err = run_cli(
        ["solve", "--input", p, "--tol", "1e-6"], capsys)
    assert code == 0, err
    assert "format=" in err            # auto ran and reported its pick
    assert "converged=True" in err


def test_solve_poisson_keeps_csr_default(capsys):
    """The synthetic generators keep their explicit csr default — no
    auto_format pass (and so no 'format=' pick line) without a file."""
    code, out, err = run_cli(
        ["solve", "--poisson", "12x12", "--tol", "1e-6"], capsys)
    assert code == 0, err
    assert "format=" not in err
    assert "converged=True" in err


def test_solve_not_converged_hints_df64(capsys):
    """A stalled fp32 solve exits 2 AND names the df64 route (VERDICT r4
    weak #6: NOT-conv must not be a UX dead end)."""
    code, out, err = run_cli(
        ["solve", "--poisson", "24x24", "--tol", "1e-30",
         "--maxiter", "3"], capsys)
    assert code == 2
    assert "converged=False" in err
    assert "--accuracy df64" in err




@pytest.mark.parametrize("dims,devices", [("8x6x5", "4"), ("12x10", "8")])
def test_solve_distributed_stencil_source(dims, devices, capsys):
    """--devices N with --method auto takes a matrix-free stencil through
    the row-partitioned solver (stored as DIA for partitioning)."""
    code, out, err = run_cli(
        ["solve", "--poisson", dims, "--format", "stencil", "--devices",
         devices, "--tol", "1e-6"], capsys)
    assert code == 0, err
    assert "converged=True" in err


def test_solve_distributed_auto_format_file_partitions_csr(tmp_path,
                                                           capsys):
    """A file input (format auto) with --devices keeps the CSR for the
    partitioner instead of converting it."""
    p = str(tmp_path / "a.mtx")
    run_cli(["gen", "--poisson", "6x6x6", "--out", p], capsys)
    code, out, err = run_cli(
        ["solve", "--input", p, "--devices", "4", "--precond", "jacobi",
         "--tol", "1e-6"], capsys)
    assert code == 0, err
    assert "format=" not in err and "converged=True" in err


def test_solve_auto_ell_with_jacobi(tmp_path, capsys):
    """The auto pick's ELL operator takes --precond jacobi (ELL carries
    its own diagonal)."""
    p = str(tmp_path / "a.mtx")
    run_cli(["gen", "--poisson", "6x6x6", "--out", p], capsys)
    code, out, err = run_cli(
        ["solve", "--input", p, "--precond", "jacobi", "--tol", "1e-6"],
        capsys)
    assert code == 0, err
    assert "format=ell" in err and "converged=True" in err


def test_solve_df64_refuses_devices(tmp_path, capsys):
    p = str(tmp_path / "prob.txt")
    run_cli(["gen", "--poisson", "6x6", "--out", p], capsys)
    with pytest.raises(SystemExit, match="one device"):
        main(["solve", "--input", p, "--accuracy", "df64", "--devices",
              "4"])


def test_solve_df64_keeps_float64_operator(tmp_path, capsys):
    """--accuracy df64 builds the file's float64 operator, not its fp32
    rounding (the df64 split needs the exact values); the fp32 path
    casts."""
    import argparse

    from cgx.cli import _build_matrix

    p = str(tmp_path / "a.mtx")
    run_cli(["gen", "--poisson", "5x4", "--out", p], capsys)
    for accuracy, dtype in (("df64", np.float64), ("fp32", np.float32)):
        args = argparse.Namespace(input=p, format=None, dtype="f32",
                                  accuracy=accuracy, devices=1)
        a, b, n = _build_matrix(args)
        assert n == 20 and a.dtype == dtype, (accuracy, a.dtype)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_run_solve_returns_the_solution(dtype, capsys):
    """cgx.cli.run_solve keeps what the solve computed: its solution
    meets the reported residual, and the exit code follows convergence."""
    from cgx.cli import parse_args, run_solve
    out = run_solve(parse_args(["solve", "--poisson", "16x16", "--format",
                                "dia", "--precond", "jacobi", "--dtype",
                                dtype]))
    x = np.asarray(out.x, np.float64)
    assert x.shape == (256,) and out.code == 0 and bool(out.res.converged)
    data = np.asarray(out.a.data, np.float64)
    ax = np.zeros(256)
    for k, off in enumerate(out.a.offsets):
        if off >= 0:
            ax[:256 - off] += data[k][:256 - off] * x[off:]
        else:
            ax[-off:] += data[k][-off:] * x[:256 + off]
    b = np.asarray(out.b, np.float64)
    true = np.linalg.norm(b - ax)
    # fp32 recomputes the residual with its own rounding: within 10 %.
    np.testing.assert_allclose(float(out.res.residual_norm), true,
                               rtol=0.1 if dtype == "f32" else 1e-6)
    assert true <= 1e-5 * np.linalg.norm(b)
    assert out.x.dtype == np.dtype("float32" if dtype == "f32"
                                   else "float64")
