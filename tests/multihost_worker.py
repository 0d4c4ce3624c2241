"""Worker for the 2-process multi-host test (run by test_multihost.py).

Each process joins the jax.distributed runtime (a simulated host
boundary over localhost), exposes 4 virtual CPU devices (8 global), builds the 2-D
(hosts x chips) mesh and runs a sharded render + a sharded train step.
Process 0 writes the results as JSON for the pytest side to compare
against the single-process ground truth.
"""
import json
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax

jax.config.update("jax_platforms", "cpu")


def main():
    coord, n_proc, pid, out_path = sys.argv[1:5]
    from mobileraytracer_tpu.parallel import mesh as pmesh
    pmesh.distributed_init(coord, int(n_proc), int(pid))

    import jax.numpy as jnp
    import numpy as np

    from mobileraytracer_tpu import constants as C
    from mobileraytracer_tpu import scenes
    from mobileraytracer_tpu.types import RenderConfig

    assert jax.device_count() == 8, jax.device_count()
    assert jax.process_count() == int(n_proc)

    scene, cam = scenes.load_builtin(C.SCENE_CORNELL, 1.0)
    scene = jax.device_put(scene)
    cfg = RenderConfig(width=32, height=32, spp=2, shader=C.SHADER_WHITTED,
                       accelerator=C.ACC_NAIVE)
    key = jax.random.PRNGKey(0)
    m = pmesh.make_mesh_2d()
    assert m.devices.shape == (int(n_proc), 8 // int(n_proc))

    out = pmesh.render_frame_sharded(scene, cam, cfg, key, m)
    # The image is sharded across processes; reduce to process-local
    # scalars then read the fully-replicated ray count.
    img_sum = float(jax.jit(lambda x: jnp.sum(x))(out["image"]))
    rays = int(out["rays"])

    target = jnp.zeros((32, 32, 3), jnp.float32)
    loss, grads = pmesh.train_step_sharded(scene, cam, cfg, key, target, m)
    loss = float(loss)
    kd_sum = float(np.asarray(grads["kd"]).sum())

    if int(pid) == 0:
        with open(out_path, "w") as f:
            json.dump({"img_sum": img_sum, "rays": rays, "loss": loss,
                       "kd_sum": kd_sum}, f)
    print(f"worker {pid} done", flush=True)


if __name__ == "__main__":
    main()
