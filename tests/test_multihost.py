"""Multi-host execution over a simulated host boundary (SURVEY.md §2.6).

Two separate OS processes join a jax.distributed runtime on localhost, each
contributing 4 virtual CPU chips; the 2-D (hosts x chips) mesh shards the
render and the gradient psum across the process boundary — the CPU
stand-in for "fast links within a host, the network across hosts".  Results must match
the single-process 8-device run exactly (the counter-based RNG makes
sharding a pure execution detail).
"""
import json
import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mobileraytracer_tpu import constants as C
from mobileraytracer_tpu import scenes
from mobileraytracer_tpu.parallel import mesh as pmesh
from mobileraytracer_tpu.types import RenderConfig

HERE = pathlib.Path(__file__).resolve().parent


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.skipif(len(jax.devices()) < 8,
                    reason="needs the 8-device virtual CPU platform")
@pytest.mark.slow
def test_two_process_mesh_matches_single_process(tmp_path):
    out = tmp_path / "mh.json"
    coord = f"localhost:{_free_port()}"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = str(HERE.parent) + os.pathsep + env.get(
        "PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, str(HERE / "multihost_worker.py"),
             coord, "2", str(pid), str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for pid in range(2)
    ]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-2000:]
    with open(out) as f:
        got = json.load(f)

    # Single-process ground truth on the local 8-device mesh.
    scene, cam = scenes.load_builtin(C.SCENE_CORNELL, 1.0)
    scene = jax.device_put(scene)
    cfg = RenderConfig(width=32, height=32, spp=2, shader=C.SHADER_WHITTED,
                       accelerator=C.ACC_NAIVE)
    key = jax.random.PRNGKey(0)
    m = pmesh.make_mesh()
    ref = pmesh.render_frame_sharded(scene, cam, cfg, key, m)
    target = jnp.zeros((32, 32, 3), jnp.float32)
    loss, grads = pmesh.train_step_sharded(scene, cam, cfg, key, target, m)

    assert got["rays"] == int(ref["rays"])
    np.testing.assert_allclose(got["img_sum"],
                               float(jnp.sum(ref["image"])), rtol=1e-5)
    np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
    np.testing.assert_allclose(got["kd_sum"],
                               float(np.asarray(grads["kd"]).sum()),
                               rtol=1e-4)
