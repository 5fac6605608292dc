"""The run refuses JAX and the JAX package by whole top-level names, and the
plain reference imports nothing of the program."""
import subprocess
import sys
import types

from benchmark import harness


def test_top_level_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "neuralbody_tpu_torch_fake",
                        types.ModuleType("neuralbody_tpu_torch_fake"))
    monkeypatch.setitem(sys.modules, "jaxtyping_fake",
                        types.ModuleType("jaxtyping_fake"))
    for name in harness.FORBIDDEN:
        monkeypatch.delitem(sys.modules, name, raising=False)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "neuralbody_tpu.ops",
                        types.ModuleType("neuralbody_tpu.ops"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert harness.forbidden_modules() == ["jax", "neuralbody_tpu"]


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.reference.latent_xyzc, benchmark.reference.nerf;"
            " bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'neuralbody_tpu_torch', 'neuralbody_tpu', 'jax'}); "
            "print(bad); sys.exit(1 if bad else 0)" % harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_card_no_result(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["run.py", "--workload",
                                      "nerf_313.render", "--seed", "1",
                                      "--seconds", "1", "--trace", "0"])
    assert harness.entry(0.0) == 2
    assert capsys.readouterr().out == ""
