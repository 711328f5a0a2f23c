"""Two-process runs of the port's parallel paths: the counterpart of
``tests/parallel/test_multihost_two_process.py``.

Two localhost processes, each driving 4 CPU shards, join one gloo
process group through ``parallel.multihost.initialize_distributed``.
The children import no JAX.  The landmark-sharded BA then runs with its
points sharded across both processes, so every LM step's psum crosses
the process boundary, and the column-sharded sweep exchanges the halo
columns of the two middle shards through the group.  The parent builds
the scenes (with the JAX package, as its own test does), compares the
children's results with each other, with one process's 8-shard run and
with JAX's ``distributed_lm_solve``.
"""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import torch

from tadataka_tpu.parallel import (
    distributed_lm_solve as jdistributed_lm_solve, make_mesh as jmake_mesh)

from tadataka_torch import interop
from tadataka_torch.parallel import (
    distributed_lm_solve, make_mesh, make_sharded_update_sweep)
from tadataka_torch.parallel.mesh import unshard
from tadataka_torch.vo.semi_dense.fast import plan_update

from tests.test_torch_parallel import _make_scene, _mse, _sweep_scene

_WORKER = textwrap.dedent('''
    import sys
    import numpy as np
    import torch

    pid, port, outdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]

    from tadataka_torch import interop
    from tadataka_torch.parallel.multihost import (
        initialize_distributed, make_host_mesh, local_slice)
    from tadataka_torch.parallel import (
        make_mesh, distributed_lm_solve, make_sharded_update_sweep)
    from tadataka_torch.parallel.mesh import unshard
    from tadataka_torch.vo.semi_dense.fast import plan_update
    assert "jax" not in sys.modules and "tadataka_tpu" not in sys.modules

    got = initialize_distributed(coordinator_address=f"127.0.0.1:{port}",
                                 num_processes=2, process_id=pid)
    assert got == (pid, 2), got
    assert torch.distributed.get_backend() == "gloo"

    # host-aware mesh: one row per process
    hmesh = make_host_mesh(["cpu"] * 4)
    assert hmesh.shape == {"host": 2, "shard": 4}, hmesh.shape
    assert [set(row.tolist()) for row in hmesh.ranks] == [{0}, {1}]
    assert local_slice(hmesh, 11) == ((0, 6) if pid == 0 else (6, 5))

    mesh = make_mesh(["cpu"] * 4)          # 8 shards over both processes
    assert mesh.size == 8 and mesh.spans_processes
    assert mesh.local_shards == list(range(4 * pid, 4 * pid + 4))

    ba = np.load(f"{outdir}/ba_scene.npz")
    poses, points, err = distributed_lm_solve(
        mesh, ba["poses"], ba["points"], ba["vi"], ba["pi"], ba["x_true"],
        max_iter=30)

    sw = np.load(f"{outdir}/sweep_scene.npz")
    key = interop.frame_from_numpy(sw["k_f"], sw["k_c"], sw["k_image"],
                                   sw["k_T"])
    refs = interop.frame_from_numpy(sw["r_f"], sw["r_c"], sw["r_image"],
                                    sw["r_T"])
    params = interop.params_from_numpy(sw["params"])
    age = torch.from_numpy(sw["age"])
    prior, var = torch.from_numpy(sw["prior"]), torch.from_numpy(sw["var"])
    plan = plan_update(key, refs, params)
    H, W = prior.shape
    out = make_sharded_update_sweep(mesh, (H, W), plan)(
        key, refs, age, prior, var, params)
    depth, variance, flags = (unshard(mesh, b, 1) for b in out)

    np.savez(f"{outdir}/out_{pid}.npz", poses=poses.numpy(),
             points=points.numpy(), err=float(err), depth=depth.numpy(),
             variance=variance.numpy(), flags=flags.numpy())
    print(f"worker {pid} done err={float(err):.3e}", flush=True)
''')


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _ba_scene():
    """The JAX two-process test's scene (seed 7, 4 viewpoints, 64
    points, noisy start)."""
    rng = np.random.default_rng(7)
    poses, points, vi, pi_, x_true = _make_scene(rng)
    poses_noisy = (poses + rng.normal(0, 0.01, poses.shape)).astype(
        np.float32)
    points_noisy = (points + rng.normal(0, 0.05, points.shape)).astype(
        np.float32)
    return poses_noisy, points_noisy, vi, pi_, x_true


def test_two_process_ba_and_sweep(tmp_path):
    """Both children return the same poses and points, bit for bit, and
    converge (error < 1e-6, the JAX test's gate); the error is within
    1e-5 of one process's 8-shard run and of JAX's distributed_lm_solve,
    and the poses within 1e-3 of each (the cross-process psum adds the
    two processes' partial sums, another association than one process's
    left-to-right sum).  The two-process sweep is torch.equal to one
    process's 8-shard sweep: the halo columns cross the group unchanged
    and no sum crosses it."""
    poses, points, vi, pi_, x_true = _ba_scene()
    np.savez(tmp_path / "ba_scene.npz", poses=poses, points=points, vi=vi,
             pi=pi_, x_true=x_true)
    kf, refs, jparams, age, prior, var = _sweep_scene(1)
    np.savez(tmp_path / "sweep_scene.npz",
             k_f=kf.focal_length, k_c=kf.offset, k_image=kf.image,
             k_T=kf.transform_wf, r_f=refs.focal_length, r_c=refs.offset,
             r_image=refs.image, r_T=refs.transform_wf,
             params=np.asarray(jparams), age=age, prior=prior, var=var)

    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = str(Path(__file__).resolve().parents[1]) + \
        os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(i), str(port), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for i in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=240)[0].decode())
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]

    out0 = np.load(tmp_path / "out_0.npz")
    out1 = np.load(tmp_path / "out_1.npz")
    for name in ("poses", "points", "err", "depth", "variance", "flags"):
        np.testing.assert_array_equal(out0[name], out1[name], err_msg=name)
    assert float(out0["err"]) < 1e-6, out0["err"]

    one = distributed_lm_solve(make_mesh(["cpu"] * 8), poses, points, vi,
                               pi_, x_true, max_iter=30)
    assert abs(float(out0["err"]) - float(one[2])) < 1e-5
    np.testing.assert_allclose(out0["poses"], one[0].numpy(), atol=1e-3)
    assert _mse(torch.from_numpy(out0["poses"]),
                torch.from_numpy(out0["points"]), vi, pi_, x_true) < 1e-6

    jposes, _, jerr = jdistributed_lm_solve(
        jmake_mesh(), poses, points, vi, pi_, x_true, max_iter=30)
    assert abs(float(out0["err"]) - float(jerr)) < 1e-5
    np.testing.assert_allclose(out0["poses"], np.asarray(jposes), atol=1e-3)

    mesh = make_mesh(["cpu"] * 8)
    inputs = (interop.frame_from_numpy(*kf), interop.frame_from_numpy(*refs),
              torch.from_numpy(age), torch.from_numpy(prior),
              torch.from_numpy(var), interop.params_from_numpy(jparams))
    plan = plan_update(inputs[0], inputs[1], inputs[5])
    single = make_sharded_update_sweep(mesh, prior.shape, plan)(*inputs)
    for name, blocks in zip(("depth", "variance", "flags"), single):
        assert torch.equal(torch.from_numpy(out0[name]),
                           unshard(mesh, blocks, 1)), name
