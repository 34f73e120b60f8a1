"""The port's file drivers (qpalm_tpu_torch.io: the QPS reader in Python and
native, the MTX reader, settings files and the CLI) against qpalm_tpu.io on
the CPU.  Every .qps file of benchmarks/maros, qps_mini and qps_hard goes
through both packages' Python parser and native parser (the port builds
its own libqpalm_io.so from native/qps_reader.cpp): the arrays, the
constant and the names are equal, bit for bit."""

import glob
import io
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import scipy.sparse as sp

from qpalm_tpu_torch.io import load_mtx, load_qps, read_settings_file
from qpalm_tpu_torch.io import native as tnative
from qpalm_tpu_torch.io.cli import main as cli_main
from qpalm_tpu_torch.io.qps import QPProblem, load_qps_python, save_qps
import torch_support  # noqa: F401

pytest.importorskip("jax")

ROOT = os.path.join(os.path.dirname(__file__), "..")
QPS_FILES = sorted(
    os.path.relpath(p, ROOT) for d in ("maros", "qps_mini", "qps_hard")
    for p in glob.glob(os.path.join(ROOT, "benchmarks", d, "*.qps")))


def _same(a: QPProblem, b) -> None:
    assert a.name == b.name and a.c == b.c
    for f in ("q", "bmin", "bmax"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    for f in ("Q", "A"):
        x, y = sp.csc_matrix(getattr(a, f)), sp.csc_matrix(getattr(b, f))
        assert x.shape == y.shape, f
        for g in ("indptr", "indices", "data"):
            assert np.array_equal(getattr(x, g), getattr(y, g)), (f, g)


def test_native_library_builds():
    """The port's native reader is built from native/qps_reader.cpp into
    qpalm_tpu_torch/_build/, never from native/'s Makefile."""
    lib = tnative.load_library()
    assert lib is not None, tnative.unavailable_reason()
    assert "qpalm_tpu_torch" in lib._name and "_build" in lib._name


def test_corpus_is_there():
    assert len(QPS_FILES) == 54


@pytest.mark.parametrize("path", QPS_FILES)
def test_qps_parsers_match_reference(path):
    from qpalm_tpu.io import native as jnative
    from qpalm_tpu.io.qps import load_qps as jload
    from qpalm_tpu.io.qps import load_qps_python as jpy

    full = os.path.join(ROOT, path)
    py = load_qps_python(full)
    _same(py, jpy(full))
    try:
        want = jnative.load_qps_native(full)
    except ValueError as err:
        # old fixed-column files: both native readers refuse them alike,
        # and load_qps falls back to the Python parser
        with pytest.raises(ValueError, match="QPS parse error") as got:
            tnative.load_qps_native(full)
        assert str(got.value) == str(err)
        _same(load_qps(full), jload(full))
        return
    _same(tnative.load_qps_native(full), want)
    _same(load_qps(full, native=True), want)


def test_save_qps_roundtrip(tmp_path):
    """save_qps then both parsers give back the problem, as the
    reference's save_qps and parser do."""
    from qpalm_tpu.io.qps import save_qps as jsave

    rng = np.random.default_rng(3)
    n, m = 7, 5
    G = sp.random(n, n, density=0.4, random_state=1)
    Q = (G @ G.T + sp.eye(n)).tocsc()
    A = sp.random(m, n, density=0.5, random_state=2).tocsc()
    q = rng.standard_normal(n)
    bl = -rng.random(m)
    bu = rng.random(m)
    bl[1], bu[3] = -np.inf, np.inf
    for save, name in ((save_qps, "port"), (jsave, "ref")):
        save(str(tmp_path / f"{name}.qps"), Q, A, q, bl, bu, c=0.25,
             name="RT")
    assert (tmp_path / "port.qps").read_text() == \
        (tmp_path / "ref.qps").read_text()
    back = load_qps_python(str(tmp_path / "port.qps"))
    _same(tnative.load_qps_native(str(tmp_path / "port.qps")), back)
    np.testing.assert_allclose(back.Q.toarray(), Q.toarray(), rtol=1e-15)
    np.testing.assert_allclose(back.q, q, rtol=1e-15)
    assert back.c == 0.25


def _write_mtx(d):
    # tests/test_io.py:192-214: the reference's five-file format
    (d / "A.mtx").write_text(
        "%%MatrixMarket matrix coordinate real general\n3 2 4\n"
        "1 1 1.0\n2 1 1.0\n1 2 1.0\n3 2 1.0\n")
    (d / "Q.mtx").write_text(
        "%%MatrixMarket matrix coordinate real symmetric\n2 2 2\n"
        "1 1 2.0\n2 2 2.0\n")
    (d / "q.mtx").write_text("%%vector\n2\n-2.0\n-6.0\n")
    (d / "bmin.mtx").write_text("%%vector\n3\n-1e30\n-1e30\n-1e30\n")
    (d / "bmax.mtx").write_text("%%vector\n3\n2.0\n2.0\n3.0\n")
    return [str(d / f) for f in ("A.mtx", "Q.mtx", "q.mtx", "bmin.mtx",
                                 "bmax.mtx")]


def test_mtx_roundtrip_and_solve(tmp_path):
    from qpalm_tpu.io import load_mtx as jload_mtx
    from qpalm_tpu_torch import Settings, solve

    files = _write_mtx(tmp_path)
    prob = load_mtx(*files)
    _same(prob, jload_mtx(*files))
    assert (prob.n, prob.m) == (2, 3) and prob.bmin[0] == -1e20
    res = solve(prob.Q, prob.A, prob.q, prob.bmin, prob.bmax,
                settings=Settings(eps_abs=1e-6, eps_rel=1e-6),
                device="cpu")
    assert res.info.status == "solved"


def test_settings_file_matches_reference(tmp_path):
    import dataclasses

    from qpalm_tpu.io import read_settings_file as jread

    p = tmp_path / "settings.txt"
    p.write_text("h1\nh2\nh3\nh4\nh5\n"
                 "eps_abs 1e-6\neps_rel 1e-6\nmax_iter 50000\nverbose 1\n"
                 "time_limit 3600\nfactorization_method 2\n# a comment\n")
    s = read_settings_file(str(p))
    assert dataclasses.asdict(s) == dataclasses.asdict(jread(str(p)))
    assert s.verbose is True and s.time_limit == 3600.0
    bad = tmp_path / "bad.txt"
    bad.write_text("h\nh\nh\nh\nh\nnot_a_setting 1\n")
    with pytest.raises(ValueError, match="not_a_setting"):
        read_settings_file(str(bad))


def _cli(argv):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = cli_main(argv)
    return rc, out.getvalue()


def test_cli_on_the_cpu(tmp_path):
    """The CLI with --device cpu: a QPS file of the corpus with a settings
    file, and the MTX five; both solve, with the reference CLI's status
    and objective."""
    from qpalm_tpu.io.cli import main as jmain

    path = os.path.join(ROOT, "benchmarks", "maros", "HS21.qps")
    st = tmp_path / "s.txt"
    st.write_text("h\nh\nh\nh\nh\neps_abs 1e-8\neps_rel 1e-8\n")
    rc, text = _cli(["--device", "cpu", path, str(st)])
    assert rc == 0
    lines = dict(ln.split(": ", 1) for ln in text.splitlines()
                 if ": " in ln)
    assert lines["Status"] == "solved"
    jout = io.StringIO()
    with redirect_stdout(jout):
        assert jmain([path, str(st)]) == 0
    jlines = dict(ln.split(": ", 1) for ln in jout.getvalue().splitlines()
                  if ": " in ln)
    assert lines["Status"] == jlines["Status"]
    assert lines["Objective"] == jlines["Objective"]
    rc, text = _cli(["--device", "cpu", "--mtx", *_write_mtx(tmp_path)])
    assert rc == 0 and "Status: solved" in text
    assert _cli([])[0] == 1
    assert _cli(["--device", "cpu", "--mtx", "A.mtx"])[0] == 1
