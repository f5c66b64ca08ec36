"""The port's frame-parallel motion module (models/motion.py) at 2 and 4
gloo ranks on the CPU, forward and gradients, against the JAX package's
``_motion_module_sharded`` on the virtual 8-device CPU mesh
(tests/conftest.py) and against the port's one-process module, from the
same numpy weights and inputs.

Each case runs in spawned processes that import no JAX; the worker
functions live here and JAX is imported inside the test functions only.
One spawn per world size runs every case of that size: the even split
(all-to-all exchange, pooled GroupNorm statistics) and an uneven frame
count (the gathered path). Tolerances: forward 1e-4, gradients 5e-5
(the GroupNorm statistics and the exchange sum in another order).
"""
import functools
import os

import numpy as np
import pytest
import torch
from test_torch_port_distributed import join_group, spawn

FWD_TOL = 1e-4
GRAD_TOL = 5e-5
C, H, W, B, HEADS, GROUPS = 16, 4, 8, 2, 2, 4
# (world size, frames): even splits take the all-to-all path, the rest
# the gathered one
CASES = {2: (4, 3), 4: (8, 6)}


def _inputs(frames):
    rng = np.random.default_rng(frames)
    x = rng.standard_normal((B * frames, H, W, C)).astype(np.float32)
    return x


def _worker(rank, world, store, params_path, out_dir):
    import torch.distributed as dist

    from video_style_transfer_tpu_torch.models.motion import motion_module
    from video_style_transfer_tpu_torch.parallel import mesh

    join_group(store, world, rank)
    try:
        grid = mesh.create_mesh(frame=world)
        for frames in CASES[world]:
            p = torch.load(params_path)
            leaves = [t.requires_grad_() for t in _leaves(p)]
            shard = grid.frame_shard(frames)
            x = torch.from_numpy(_inputs(frames)).view(B, frames, H, W, C)
            xl = x[:, shard.slice()].reshape(-1, H, W, C).clone() \
                .requires_grad_()
            y = motion_module(p, xl, num_frames=shard.local, heads=HEADS,
                              norm_num_groups=GROUPS, frame_shard=shard)
            # each rank's loss is its share; the sum over ranks is the
            # one-process loss, so the summed parameter gradients are its
            y_full = y.view(B, shard.local, H, W, C)
            w = _weights(frames)[:, shard.slice()]
            (y_full * y_full * w).sum().backward()
            grads = [t.grad.clone() for t in leaves]
            from video_style_transfer_tpu_torch.parallel.distributed import (
                all_reduce_tensors)
            all_reduce_tensors(grads)
            torch.save({"y": y.detach(), "dx": xl.grad,
                        "dparams": grads,
                        "slice": (shard.start, shard.start + shard.local),
                        "even": shard.even},
                       os.path.join(out_dir, f"f{frames}_r{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _weights(frames):
    """Loss weights: every output element weighs differently."""
    n = B * frames * H * W * C
    return torch.linspace(0.5, 1.5, n).view(B, frames, H, W, C)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


@functools.lru_cache(maxsize=None)
def _jax_params():
    import jax

    from video_style_transfer_tpu.models.motion import init_motion_module
    return init_motion_module(jax.random.PRNGKey(0), C, num_layers=1,
                              heads=HEADS)


def _torch_params():
    from video_style_transfer_tpu_torch.utils.convert import convert_tree
    return convert_tree(_jax_params())


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """{world: {frames: [per-rank results]}} of one spawn per world."""
    root = tmp_path_factory.mktemp("motion_sharded")
    params_path = str(root / "params.pt")
    torch.save(_torch_params(), params_path)
    out = {}
    for world in CASES:
        d = root / f"w{world}"
        d.mkdir()
        spawn(_worker, (world, str(d / "store"), params_path, str(d)),
              nprocs=world)
        out[world] = {f: [torch.load(d / f"f{f}_r{r}.pt")
                          for r in range(world)] for f in CASES[world]}
    return out


def _one_process(frames):
    """The port's one-process module: output and gradients."""
    from video_style_transfer_tpu_torch.models.motion import motion_module
    p = _torch_params()
    leaves = [t.requires_grad_() for t in _leaves(p)]
    x = torch.from_numpy(_inputs(frames)).requires_grad_()
    y = motion_module(p, x, num_frames=frames, heads=HEADS,
                      norm_num_groups=GROUPS)
    yv = y.view(B, frames, H, W, C)
    (yv * yv * _weights(frames)).sum().backward()
    return y.detach(), x.grad, [t.grad for t in leaves]


def _jax_reference(frames, world):
    """JAX's motion_module on the virtual mesh (its shard_map path where
    the split is even, its fallback elsewhere): output, dx and the
    parameter gradients in the port's layout."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from video_style_transfer_tpu.models.motion import (
        _sharded_mesh_info, motion_module)
    from video_style_transfer_tpu.parallel.mesh import create_mesh
    from video_style_transfer_tpu_torch.utils.convert import convert_tree

    p = _jax_params()
    x = jnp.asarray(_inputs(frames))
    w = jnp.asarray(_weights(frames).numpy()).reshape(x.shape)
    # the JAX layout splits the (B*F) rows b-major over the mesh, so a
    # group of `world` devices per clip needs B * world devices
    mesh = create_mesh(jax.devices()[:B * world])

    def loss(p, x):
        y = motion_module(p, x, num_frames=frames, heads=HEADS,
                          norm_num_groups=GROUPS)
        return jnp.sum(y * y * w), y

    even = frames % world == 0
    spec = P(("data", "frame")) if even else P()
    xs = jax.device_put(x, NamedSharding(mesh, spec))
    with mesh:
        if even:
            assert _sharded_mesh_info(B, frames, H * W) is not None
        (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(p, xs)
    return (np.asarray(y), np.asarray(gx),
            [t.numpy() for t in _leaves(convert_tree(gp))])


def _check(results, frames, want_y, want_dx, want_dp, tol_y, tol_g):
    full = np.asarray(want_y).reshape(B, frames, H, W, C)
    full_dx = np.asarray(want_dx).reshape(B, frames, H, W, C)
    for res in results:
        sl = slice(*res["slice"])
        got = res["y"].numpy().reshape(B, -1, H, W, C)
        np.testing.assert_allclose(got, full[:, sl], atol=tol_y, rtol=0)
        np.testing.assert_allclose(res["dx"].numpy().reshape(got.shape),
                                   full_dx[:, sl], atol=tol_g, rtol=1e-5)
        for g, want in zip(res["dparams"], want_dp):
            np.testing.assert_allclose(g.numpy(), np.asarray(want),
                                       atol=tol_g, rtol=1e-5)


@pytest.mark.parametrize("world,frames", [(w, f) for w in CASES
                                          for f in CASES[w]])
def test_sharded_motion_matches_one_process(spawned, world, frames):
    results = spawned[world][frames]
    assert [r["even"] for r in results] == [frames % world == 0] * world
    y, dx, dp = _one_process(frames)
    _check(results, frames, y.numpy(), dx.numpy(),
           [g.numpy() for g in dp], FWD_TOL, GRAD_TOL)


@pytest.mark.parametrize("world,frames", [(w, f) for w in CASES
                                          for f in CASES[w]])
def test_sharded_motion_matches_jax(spawned, world, frames):
    y, dx, dp = _jax_reference(frames, world)
    _check(spawned[world][frames], frames, y, dx, dp, FWD_TOL, GRAD_TOL)
