"""chip_smoke.py rehearsed on the CPU, and the compile-cache rule.

The smoke test itself runs only on a GPU; here its phase functions run at
a tiny size on the CPU backend (both "devices" are the CPU), and the
script must refuse a CPU-only JAX.
"""
import importlib.util
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from mobileraytracer_tpu import constants as C
from mobileraytracer_tpu import scenes
from mobileraytracer_tpu.types import RenderConfig
from mobileraytracer_tpu.utils import compile_cache

REPO = pathlib.Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(args, cwd, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_without_gpu(where, tmp_path):
    """Exits non-zero and prints no result line: on a CPU-only JAX, and
    from a directory that holds the script and nothing else of the repo
    (the package is then missing, or not the one beside the script)."""
    if where == "repo":
        proc = _run(["chip_smoke.py"], cwd=REPO)
    else:
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        proc = _run(["chip_smoke.py"], cwd=tmp_path,
                    env_extra={"PYTHONPATH": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_phases_rehearsed_on_cpu(capsys):
    """Every single-device phase at a tiny size: cornell at 32^2 with the
    naive scan and the BVH, traversal parity, goldens, gradients, CLI."""
    cs = _chip_smoke()
    cpu = jax.devices("cpu")[0]
    bvh = RenderConfig(width=32, height=32, spp=1, shader=C.SHADER_WHITTED,
                       accelerator=C.ACC_BVH)
    naive = RenderConfig(width=32, height=32, spp=1,
                         shader=C.SHADER_WHITTED, accelerator=C.ACC_NAIVE)
    scene, cam = cs.phase_load(
        lambda: (*scenes.load_builtin(C.SCENE_CORNELL2, 1.0), {}), bvh)
    got = cs.phase_traversal(scene, cam, side=8, device=cpu, cpu=cpu)
    assert got == {"ties": 0, "oracle_misses": 0}
    assert all(x > 0 for x in cs.traversal_bar(scene, cam, side=8, reps=1))
    img_b = cs.phase_whitted(scene, cam, bvh)
    img_n = cs.phase_whitted(scene, cam, naive)
    np.testing.assert_allclose(img_b, img_n, atol=1e-6)
    cs.phase_pathtracer(scene, cam, RenderConfig(
        width=32, height=32, spp=2, shader=C.SHADER_PATHTRACER,
        accelerator=C.ACC_BVH))
    res = cs.phase_goldens(goldens=cs_goldens(), size=32)
    assert len(res) == 2
    err = cs.phase_gradients(scene, cam, bvh, small_size=16, edge_budget=64,
                             shadow_budget=16, cpu=cpu)
    assert err == 0.0
    cs.phase_cli(size=32)
    out = capsys.readouterr().out
    for phase in ("load", "traversal", "whitted", "pathtracer", "goldens",
                  "gradients", "cli"):
        assert f"[{phase}]" in out


def cs_goldens():
    from mobileraytracer_tpu.utils.golden import ANALYTIC_GOLDENS
    return ANALYTIC_GOLDENS[1:2]


def test_chip_smoke_four_rehearsed_on_cpu():
    """The --four path on four virtual CPU devices at 64^2 (at 32^2 the
    single-device batch would take the small-batch walker and the
    sharded one would not, so the two would be different programs)."""
    cs = _chip_smoke()
    cfg = RenderConfig(width=64, height=64, spp=1, shader=C.SHADER_WHITTED,
                       accelerator=C.ACC_BVH, nee_share=128)
    scene, cam = cs.phase_load(
        lambda: (*scenes.load_builtin(C.SCENE_CORNELL2, 1.0), {}), cfg)
    cs.phase_four(scene, cam, cfg, grad_size=16)


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_location(env_set, tmp_path, monkeypatch):
    """JAX_COMPILATION_CACHE_DIR wins when set, and a compile writes its
    entry there; otherwise the cache is the fixed .jax_cache/ at the root
    of the checkout."""
    if env_set:
        target = tmp_path / "cache"
        monkeypatch.setenv(compile_cache.ENV_VAR, str(target))
        assert compile_cache.cache_dir() == str(target)
        code = ("from mobileraytracer_tpu.utils.compile_cache import "
                "enable_compile_cache; import jax; "
                "print(enable_compile_cache()); "
                "jax.jit(lambda x: x * 3 + 1)(2.0).block_until_ready()")
        proc = _run(["-c", code], cwd=tmp_path,
                    env_extra={compile_cache.ENV_VAR: str(target)})
        assert proc.returncode == 0, proc.stderr
        assert proc.stdout.strip() == str(target)
        assert any(target.iterdir())
    else:
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
        assert compile_cache.cache_dir() == str(REPO / ".jax_cache")
