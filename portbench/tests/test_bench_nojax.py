"""The check that nothing the benchmark runs loads JAX or the JAX
package, by whole top-level names."""

import subprocess
import sys
import types

import pytest

from portbench import generate, nojax


def test_names_compared_whole():
    assert nojax.loaded(["reseek_tpu_torch", "reseek_tpu_torch.search",
                         "portbench", "jaxtyping"]) == []
    assert nojax.loaded(["reseek_tpu.search", "jax.numpy", "jaxlib",
                         "flax.linen", "numpy"]) == ["flax", "jax", "jaxlib",
                                                      "reseek_tpu"]


def test_benchmark_and_port_load_no_jax():
    """Everything a run imports, in a fresh process."""
    code = ("import portbench.harness, portbench.control, portbench.trace, "
            "portbench.kinds.self_search, portbench.kinds.fast_search, "
            "portbench.reference.search.host, "
            "portbench.reference.search.prefilter, "
            "portbench.reference.align.mkf, "
            "reseek_tpu_torch.search.driver, reseek_tpu_torch.chain, "
            "reseek_tpu_torch.device\n"
            "from portbench import nojax\n"
            "print(nojax.loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=generate.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_harness_refuses_a_loaded_jax_package():
    """With a module of that name loaded, a run exits non-zero and prints
    no result."""
    code = ("import sys, types\n"
            "sys.modules['reseek_tpu'] = types.ModuleType('reseek_tpu')\n"
            "from portbench.harness import main\n"
            "sys.exit(main(['--workload', 'scop40.sensitive', '--seed', '1',"
            " '--seconds', '1']))")
    out = subprocess.run([sys.executable, "-c", code], cwd=generate.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "reseek_tpu" in out.stderr


@pytest.fixture
def plant(monkeypatch):
    """``plant()`` puts a module named reseek_tpu into sys.modules, as an
    import of the JAX package would; the process's own entry (if any) is
    put back afterwards."""
    saved = sys.modules.pop("reseek_tpu", None)

    def do():
        sys.modules["reseek_tpu"] = types.ModuleType("reseek_tpu")
    yield do
    sys.modules.pop("reseek_tpu", None)
    if saved is not None:
        sys.modules["reseek_tpu"] = saved


@pytest.mark.parametrize("where", ["check", "metric_reader"])
def test_jax_package_loaded_after_the_window(where, tiny_root, monkeypatch,
                                             plant, capsys):
    """The JAX package loaded by the output check or by a metric's reader,
    after the window: the run exits non-zero and prints no result."""
    from portbench import harness
    from portbench.tests.test_bench_harness import FakeWorkload

    class Late(FakeWorkload):
        def check(self, records):
            if where == "check":
                plant()
            return super().check(records)

    mod = types.SimpleNamespace(Workload=Late)
    monkeypatch.setattr(harness, "kind_module", lambda traffic: mod)
    if where == "metric_reader":
        (tiny_root / "portbench" / "metrics" / "setup_s.py").write_text(
            "import sys, types\n"
            "def read(run):\n"
            "    sys.modules['reseek_tpu'] = types.ModuleType('reseek_tpu')\n"
            "    return run['setup_s']\n")
    monkeypatch.setattr(generate, "ROOT", tiny_root)
    run = harness.run
    monkeypatch.setattr(harness, "run",
                        lambda *a, **k: run(*a, **{**k, "device": "cpu"}))
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "cpu")
    rc = harness.main(["--workload", "scop40.sensitive", "--seed", "1",
                       "--seconds", "0"])
    out = capsys.readouterr()
    assert rc != 0
    assert '"correct"' not in out.out
    assert "reseek_tpu" in out.err
