"""
``chip_smoke.py``: its phases at tiny sizes on the CPU, its four-card
phases on 4 of the 8 virtual CPU devices, its refusal without a GPU,
and — marked ``chip`` — its one-card phases at full size on the card.
"""

import json
import os
import shutil
import subprocess
import sys
from functools import partial

import numpy as np
import pytest

import jax

import chip_smoke as cs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(n_stations=4, nt=128, n_distances=6, n_depths=3)


@pytest.fixture(scope="module")
def tiny_problem(tmp_path_factory):
    return cs.build_fullmt(str(tmp_path_factory.mktemp("fullmt")), **TINY)


class TestPhasesOnCPU:
    def test_fullmt_sample(self, tiny_problem):
        out = cs.phase_fullmt_sample(tiny_problem, n_chains=16, n_steps=4,
                                     max_stages=3)
        assert out["beta"] > 0.0
        assert out["table_shape"] == [6, 3, 6, 3, 65, 2]
        assert out["logp_memory"]

    def test_fullmt_reference(self, tiny_problem):
        out = cs.phase_fullmt_reference(tiny_problem, n=6, n_timed=8)
        assert out["precision"] == "highest"
        # on the CPU backend both sides are the same program
        assert out["max_rel_llk"] == 0.0

    def test_gather(self, tiny_problem):
        table = tiny_problem.make_logp_fn()[1][0][0]["table"]
        out = cs.phase_gather(table, n_chains=8, n_targets=4)
        assert out["max_err_rel_table_max"] <= out["tol"]

    def test_kinematic_stack(self):
        out = cs.phase_kinematic_stack(C=8, T=2, P=5, D=3, S=6, N=16,
                                       n_check=4)
        for interp in ("nearest_neighbor", "multilinear"):
            assert out[interp]["max_rel_err"] <= out[interp]["tol"]


class TestFourCardPhasesOnVirtualDevices:
    """The ``--four-cards`` phases on 4 virtual CPU devices."""

    def test_four_logp(self, tiny_problem):
        out = cs.phase_four_logp(tiny_problem, 4, n_chains=16)
        assert out["max_rel_vs_one_device"] <= out["rtol"]

    def test_four_smc(self, tiny_problem):
        out = cs.phase_four_smc(tiny_problem, 4, n_chains=16, n_steps=4)
        assert out["state_devices"] == 4

    def test_four_kinematic(self):
        out = cs.phase_four_kinematic(4, C=8, T=4, P=5, D=3, S=6, N=16)
        assert out["mesh"] == [2, 2]

    def test_four_pt(self, tiny_problem):
        out = cs.phase_four_pt(tiny_problem, 4, n_samples=16)
        assert out["ladder"] == 16


class TestScript:
    def _run(self, cwd, env_extra):
        env = {**os.environ, **env_extra}
        return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                              env=env, capture_output=True, text=True,
                              timeout=300)

    def test_refuses_cpu_platform(self):
        r = self._run(ROOT, {"JAX_PLATFORMS": "cpu"})
        assert r.returncode != 0
        assert "no GPU" in r.stderr
        assert '"ok"' not in r.stdout

    def test_fails_without_the_repo(self, tmp_path):
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        r = self._run(str(tmp_path), {"JAX_PLATFORMS": "cpu"})
        assert r.returncode != 0
        assert '"ok"' not in r.stdout

    def test_main_refuses_in_process(self):
        with pytest.raises(SystemExit, match="no GPU"):
            cs.main([])

    @pytest.mark.parametrize("given,want", [
        ("cuda", "cuda,cpu"), ("cuda,cpu", "cuda,cpu"), ("cpu", "cpu"),
        (None, None)])
    def test_keeps_the_cpu_backend(self, monkeypatch, given, want):
        if given is None:
            monkeypatch.delenv("JAX_PLATFORMS", raising=False)
        else:
            monkeypatch.setenv("JAX_PLATFORMS", given)
        cs._platforms_with_cpu()
        assert os.environ.get("JAX_PLATFORMS") == want


@pytest.mark.parametrize("argv,phases", [
    ([], ["fullmt_sample", "fullmt_reference", "gather", "kinematic_stack",
          "f32_llk"]),
    (["--four-cards"], ["four_logp", "four_smc", "four_kinematic",
                        "four_pt"])])
def test_main_prints_phases_then_the_contract_line(monkeypatch, capsys,
                                                   tmp_path, argv, phases):
    """main()'s orchestration with the card faked and every phase at a
    tiny size: one line per phase, the contract line last."""
    monkeypatch.setattr(cs, "phase_device", lambda: {
        "platform": "gpu", "kind": "fake", "count": len(jax.devices())})
    monkeypatch.setattr(cs, "nvidia_smi", lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    real_build = cs.build_fullmt
    monkeypatch.setattr(cs, "build_fullmt",
                        lambda out: real_build(out, **TINY))
    tiny = {"phase_fullmt_sample": dict(n_chains=16, n_steps=4, max_stages=2),
            "phase_fullmt_reference": dict(n=4, n_timed=8),
            "phase_gather": dict(n_chains=4, n_targets=3),
            "phase_kinematic_stack": dict(C=4, T=2, P=3, D=3, S=4, N=8,
                                          n_check=2),
            "phase_four_logp": dict(n_chains=16),
            "phase_four_smc": dict(n_chains=16, n_steps=2),
            "phase_four_kinematic": dict(C=4, T=2, P=3, D=3, S=4, N=8),
            "phase_four_pt": dict(n_samples=8)}
    for name, kw in tiny.items():
        monkeypatch.setattr(cs, name, partial(getattr(cs, name), **kw))
    monkeypatch.setattr(cs, "phase_f32_llk",
                        lambda: {"n256": cs.f32_llk_check(256, 10.0)})
    assert cs.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "NVIDIA H100 80GB HBM3, 700.00 W"
    got = [json.loads(line)["phase"] for line in lines[1:-1]]
    assert got == ["device"] + phases
    last = json.loads(lines[-1])
    assert last == {"ok": True, "device": {
        "platform": "cpu", "kind": "cpu", "count": len(jax.devices())}}


@pytest.fixture
def card():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs the GPU (JAX_PLATFORMS=cuda,cpu python -m "
                    "pytest -m chip tests/)")
    return jax.devices()[0]


@pytest.fixture
def full_problem(card, tmp_path):
    return cs.build_fullmt(str(tmp_path / "fullmt"))


@pytest.mark.chip
class TestOnCard:
    def test_fullmt_sample(self, full_problem):
        assert cs.phase_fullmt_sample(full_problem)["beta"] > 0.0

    def test_fullmt_reference(self, full_problem):
        out = cs.phase_fullmt_reference(full_problem)
        assert out["max_rel_llk"] <= out["rtol"]

    def test_gather(self, full_problem):
        table = full_problem.make_logp_fn()[1][0][0]["table"]
        assert np.isfinite(cs.phase_gather(table)["max_err_rel_table_max"])

    def test_kinematic_stack(self, card):
        cs.phase_kinematic_stack()

    def test_f32_llk(self, card):
        cs.phase_f32_llk()
