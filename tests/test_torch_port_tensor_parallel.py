"""Tensor parallelism in the port (parallel/tensor.py, the model axis of
parallel/mesh.py, ``cli.infer --tp``) against the JAX package's
parallel/tensor.py:

- without processes: which leaves ``tp_shard`` slices and on which axis
  (the JAX ``tp_spec``'s leaves, JAX's test_spec_tree_shapes and
  test_motion_and_lora_leaves_replicated), every rank's slices put back
  together giving the whole weights bitwise, and SDXL's uneven heads at
  --tp 4 from shapes alone (meta tensors);
- two gloo processes (one spawn; the children import no JAX, the JAX
  outputs come from this process): the tiny UNet's TP forward in modes
  base and both (live LoRA branches on every projection, distinct content
  and style streams) against JAX's ``unet_apply`` at JAX's own TP test
  tolerance (rtol 2e-4, atol 2e-5) and against the port's one-process
  forward, and ``infer --smoke --tp 2`` against one process's images
  (latents within 1e-4, uint8 within one level), written by process 0
  alone;
- four gloo processes: ``infer --smoke --dp 2 --tp 2`` over three seeds.
"""
import functools
import os

import numpy as np
import pytest
import torch
from test_torch_port_distributed import join_group, spawn

from video_style_transfer_tpu_torch.cli import infer
from video_style_transfer_tpu_torch.config import UNetConfig
from video_style_transfer_tpu_torch.lora import surgery as tsurgery
from video_style_transfer_tpu_torch.models.layers import Init, MetaInit
from video_style_transfer_tpu_torch.models.unet import init_unet
from video_style_transfer_tpu_torch.parallel import mesh, tensor
from video_style_transfer_tpu_torch.utils import convert

IMAGE = ["--smoke", "--device", "cpu", "--prompt", "a dog", "--mode",
         "both", "--prompt_content", "a dog", "--prompt_style",
         "in watercolor"]


def _grid(tp, index):
    return mesh.Grid(data=1, frame=1, rank=index, model=tp)


# JAX is imported by the functions that use it: the spawned children
# import this module and must not import JAX


@functools.lru_cache(maxsize=None)
def _jax_unet(lora):
    """(JAX cfg, params, state) of the tiny UNet (JAX's TP test's
    weights), with rank-4 UnZipLoRA factors and mergers away from one
    when `lora`."""
    import jax
    import jax.numpy as jnp
    from video_style_transfer_tpu.config import UNetConfig as JUNetConfig
    from video_style_transfer_tpu.lora import surgery as jsurgery
    from video_style_transfer_tpu.models import unet as junet

    cfg = JUNetConfig.tiny()
    params = junet.init_unet(jax.random.PRNGKey(0), cfg)
    if not lora:
        return cfg, params, None
    params, state = jsurgery.insert_unziplora(params, jax.random.PRNGKey(1),
                                              rank=4)
    rng = np.random.default_rng(2)

    def mergers(path, leaf):
        name = getattr(path[-1], "key", "")
        if isinstance(name, str) and name.startswith("merge_"):
            return jnp.asarray(1.0 + 0.5 * rng.standard_normal(leaf.shape),
                               jnp.float32)
        return leaf
    return cfg, jax.tree_util.tree_map_with_path(mergers, params), state


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (i,))
    else:
        yield path, tree


def _jax_axis(spec, ndim):
    """The port's axis of a leaf JAX shards on `spec` (None: whole; JAX
    kernels are (.., in, out), the port's weights (out, in))."""
    spec = tuple(spec)
    if "model" not in spec:
        return None
    return {(-1, 2): 0, (-2, 2): 1, (-1, 1): 0}[
        (spec.index("model") - len(spec), ndim)]


def test_shard_slices_the_leaves_tp_spec_shards():
    import jax
    from jax.sharding import PartitionSpec as P
    from video_style_transfer_tpu.parallel.tensor import tp_spec_tree

    _, jparams, _ = _jax_unet(lora=False)
    jspecs = {tuple(getattr(p, "key", getattr(p, "idx", None))
                    for p in path): s
              for path, s in jax.tree_util.tree_flatten_with_path(
                  tp_spec_tree(jparams),
                  is_leaf=lambda x: isinstance(x, P))[0]}
    full = convert.convert_tree(jparams)
    shard = tensor.tp_shard(full, UNetConfig.tiny(), _grid(2, 1))
    n_sliced = 0
    for path, leaf in _flat(full):
        got = tsurgery.tree_get(shard, path)
        # the JAX leaf: stacked layers (its spec leads with the layer
        # axis) in place of the list index; kernel, or a norm's scale
        jpath = list(path)
        stacked = "transformer_blocks" in jpath
        if stacked:
            del jpath[jpath.index("transformer_blocks") + 1]
        if jpath[-1] == "weight":
            jpath[-1] = "scale" if leaf.dim() == 1 else "kernel"
        spec = tuple(jspecs[tuple(jpath)])
        axis = _jax_axis(spec[1:] if stacked else spec, leaf.dim())
        if axis is None:
            assert got is leaf, path
            continue
        n_sliced += 1
        want = list(leaf.shape)
        want[axis] //= 2
        assert list(got.shape) == want, path
    # q, k, v and out of attn1 and attn2, ff.proj's weight and bias and
    # ff.out's weight in each of the 4 tiny transformer layers (down 1,
    # mid 1, up 2)
    assert n_sliced == 11 * 4
    blk = shard["up_blocks"][0]["attentions"][0]["transformer_blocks"][0]
    assert blk["attn1"]["tp"].heads == 2 and blk["ff"]["tp"].heads is None


def test_motion_leaves_whole_and_lora_follows_its_projection():
    cfg = UNetConfig.tiny(use_motion_modules=True)
    full = init_unet(Init(0), cfg)
    full, state = tsurgery.insert_unziplora(full, Init(1), rank=4)
    tsurgery.insert_temporal_lora(full, Init(2), rank=4)
    grid = _grid(2, 0)
    shard = tensor.tp_shard(full, cfg, grid)
    sstate = tensor.tp_shard_state(state, full, cfg, grid)
    for path, leaf in _flat(full):
        if "motion_modules" in path or "attentions" not in path:
            assert tsurgery.tree_get(shard, path) is leaf, path
    attn = ("up_blocks", 0, "attentions", 0, "transformer_blocks", 0,
            "attn2")
    a, s = tsurgery.tree_get(full, attn), tsurgery.tree_get(shard, attn)
    half = a["to_q"]["weight"].shape[0] // 2
    for name in ("to_q", "to_k", "to_v"):
        lo, ls = a[name]["lora"], s[name]["lora"]
        assert ls["content"]["down"] is lo["content"]["down"]
        assert torch.equal(ls["style"]["up"], lo["style"]["up"][:, :half])
        assert torch.equal(ls["merge_content"], lo["merge_content"][:half])
        st, sst = (tsurgery.tree_get(x, attn + (name,))
                   for x in (state, sstate))
        assert torch.equal(sst["mask_style"], st["mask_style"][:half])
        assert sst["use_mask_content"] is st["use_mask_content"]
    lo, ls = a["to_out"]["lora"], s["to_out"]["lora"]
    assert torch.equal(ls["content"]["down"], lo["content"]["down"][:half])
    assert ls["style"]["up"] is lo["style"]["up"]
    assert ls["merge_style"] is lo["merge_style"]
    assert tsurgery.tree_get(sstate, attn + ("to_out",)) is \
        tsurgery.tree_get(state, attn + ("to_out",))


@pytest.mark.parametrize("tp", [2, 3])
def test_rank_slices_put_back_the_whole_weights(tp):
    cfg = UNetConfig.tiny()
    full = init_unet(Init(0), cfg)
    full, _ = tsurgery.insert_unziplora(full, Init(1), rank=4)
    shards = [tensor.tp_shard(full, cfg, _grid(tp, r)) for r in range(tp)]
    blocks = [("down_blocks", 1), ("mid_block",), ("up_blocks", 0)]
    for prefix in blocks:
        t2d = tsurgery.tree_get(full, prefix + ("attentions",))
        for j, t in enumerate(t2d):
            for k, layer in enumerate(t["transformer_blocks"]):
                base = prefix + ("attentions", j, "transformer_blocks", k)
                parts = [tsurgery.tree_get(s, base) for s in shards]
                for name in ("attn1", "attn2"):
                    heads = [p[name]["tp"].heads for p in parts]
                    assert heads == list(mesh.split_counts(4, tp))
                    for proj in ("to_q", "to_k", "to_v"):
                        assert torch.equal(torch.cat(
                            [p[name][proj]["weight"] for p in parts]),
                            layer[name][proj]["weight"])
                        assert torch.equal(torch.cat(
                            [p[name][proj]["lora"]["content"]["up"]
                             for p in parts], 1),
                            layer[name][proj]["lora"]["content"]["up"])
                    assert torch.equal(torch.cat(
                        [p[name]["to_out"]["weight"] for p in parts], 1),
                        layer[name]["to_out"]["weight"])
                    assert torch.equal(torch.cat(
                        [p[name]["to_out"]["lora"]["style"]["down"]
                         for p in parts]),
                        layer[name]["to_out"]["lora"]["style"]["down"])
                # GEGLU: unpair each rank's [W_h_r ; W_g_r]
                for key in ("weight", "bias"):
                    halves = [p["ff"]["proj"][key].chunk(2) for p in parts]
                    assert all(h.shape[0] % 8 == 0 for h, _ in halves)
                    assert torch.equal(
                        torch.cat([h for h, _ in halves]
                                  + [g for _, g in halves]),
                        layer["ff"]["proj"][key])
                assert torch.equal(torch.cat(
                    [p["ff"]["out"]["weight"] for p in parts], 1),
                    layer["ff"]["out"]["weight"])


def test_sdxl_uneven_heads_at_tp4_from_shapes():
    cfg = UNetConfig.sdxl()
    full = init_unet(MetaInit(torch.bfloat16), cfg)
    shards = [tensor.tp_shard(full, cfg, _grid(4, r)) for r in range(4)]
    for prefix, heads, counts in (
            (("down_blocks", 1), 10, (3, 3, 2, 2)),
            (("up_blocks", 0), 20, (5, 5, 5, 5)),
            (("mid_block",), 20, (5, 5, 5, 5))):
        base = prefix + ("attentions", 0, "transformer_blocks", 0)
        for r, s in enumerate(shards):
            layer = tsurgery.tree_get(s, base)
            c = layer["attn1"]["to_q"]["weight"].shape[1]
            assert layer["attn1"]["tp"].heads == counts[r]
            assert layer["attn2"]["to_k"]["weight"].shape == (
                64 * counts[r], 2048)
            assert layer["attn2"]["to_out"]["weight"].shape == (
                c, 64 * counts[r])
            assert layer["ff"]["proj"]["weight"].shape == (2 * c, c)
            assert layer["ff"]["out"]["weight"].shape == (c, c)
            assert layer["attn1"]["to_q"]["weight"].device.type == "meta"
    assert tensor.max_tp(cfg) == 10 and tensor.max_tp(UNetConfig.tiny()) == 4
    with pytest.raises(SystemExit, match="smallest head count 10"):
        tensor.tp_shard(full, cfg, _grid(11, 0))


def test_cli_refuses_tp_above_the_head_count():
    args = infer.build_parser().parse_args(IMAGE + ["--tp", "5"])
    with pytest.raises(SystemExit, match="smallest head count 4"):
        infer.generate(args)


# ------------------------------------------------------ two processes

def _inputs():
    """JAX's TP test inputs, and a content and a style stream of their
    own."""
    import jax
    import jax.numpy as jnp
    from video_style_transfer_tpu.config import UNetConfig as JUNetConfig

    cfg = JUNetConfig.tiny()
    ks = jax.random.split(jax.random.PRNGKey(5), 6)
    lat = jax.random.normal(ks[0], (4, 8, 8, cfg.in_channels))
    ctx = [jax.random.normal(ks[i], (4, 7, cfg.cross_attention_dim))
           for i in (1, 4, 5)]
    pooled = jax.random.normal(ks[2], (4, 32))
    tids = jnp.tile(jnp.asarray([[16, 16, 0, 0, 16, 16]], jnp.float32),
                    (4, 1))
    return lat, jnp.full((4,), 7.0), ctx, pooled, tids


def _forward(params, state, inputs, mode):
    from video_style_transfer_tpu_torch.models.unet import unet_apply
    lat, t, ctx, pooled, tids = inputs
    with torch.no_grad():
        return unet_apply(params, UNetConfig.tiny(), lat, t,
                          tuple(ctx) if mode == "both" else
                          (ctx[0], None, None), pooled, tids, mode=mode,
                          state=state)


def _worker2(rank, root):
    import sys

    from video_style_transfer_tpu_torch.parallel import distributed

    assert "jax" not in sys.modules

    join_group(os.path.join(root, "store"), 2, rank)
    data = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
    grid = mesh.create_mesh(data=1, model=2)
    assert (grid.model, grid.model_index) == (2, rank)
    res = {}
    for mode in ("base", "both"):
        params, state = data[mode]
        distributed.MODEL_REDUCED_BYTES = 0
        res[mode] = _forward(
            tensor.tp_shard(params, UNetConfig.tiny(), grid),
            tensor.tp_shard_state(state, params, UNetConfig.tiny(), grid),
            data["inputs"], mode)
        res[f"{mode}_bytes"] = distributed.MODEL_REDUCED_BYTES
    report = {}
    res["images"] = infer.generate(infer.build_parser().parse_args(
        IMAGE + ["--tp", "2", "--seeds", "0", "3"]), report)
    res["image_report"] = report["images"]
    res["paths"] = infer.main(IMAGE + ["--tp", "2", "--seeds", "0",
                                       "--output_dir",
                                       os.path.join(root, f"out{rank}")])
    torch.save(res, os.path.join(root, f"r{rank}.pt"))


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    from video_style_transfer_tpu.models import unet as junet

    root = tmp_path_factory.mktemp("tp2")
    inputs = _inputs()
    want, data = {}, {"inputs": None}
    for mode, lora in (("base", False), ("both", True)):
        jcfg, jp, jstate = _jax_unet(lora)
        lat, t, ctx, pooled, tids = inputs
        want[mode] = np.asarray(junet.unet_apply(
            jp, jcfg, lat, t, tuple(ctx) if mode == "both" else
            (ctx[0], None, None), pooled, tids, mode=mode, state=jstate))
        data[mode] = (convert.convert_tree(jp),
                      None if jstate is None else
                      convert.convert_lora_state(jstate))
    data["inputs"] = (torch.from_numpy(np.array(inputs[0])),
                      torch.from_numpy(np.array(inputs[1])),
                      [torch.from_numpy(np.array(c)) for c in inputs[2]],
                      torch.from_numpy(np.array(inputs[3])),
                      torch.from_numpy(np.array(inputs[4])))
    torch.save(data, root / "inputs.pt")
    spawn(_worker2, (str(root),), nprocs=2)
    ranks = [torch.load(root / f"r{r}.pt", weights_only=False)
             for r in range(2)]
    return root, data, want, ranks


@pytest.mark.parametrize("mode", ["base", "both"])
def test_tp_forward_matches_jax_and_one_process(two, mode):
    _, data, want, ranks = two
    params, state = data[mode]
    one = _forward(params, state, data["inputs"], mode)
    for r in ranks:
        np.testing.assert_allclose(r[mode].numpy(), want[mode], rtol=2e-4,
                                   atol=2e-5)
        np.testing.assert_allclose(r[mode].numpy(), one.numpy(), rtol=2e-4,
                                   atol=2e-5)
        # 3 reductions (attn1, attn2, ff) in each of the 4 layers, all at
        # the 4 x 4 level: 4 x 16 rows of 64 fp32 channels each
        assert r[f"{mode}_bytes"] == 4 * 3 * (4 * 16) * 64 * 4


def test_infer_tp2_gives_the_one_process_images(two):
    root, _, _, ranks = two
    report = {}
    want = infer.generate(infer.build_parser().parse_args(
        IMAGE + ["--seeds", "0", "3"]), report)
    for r in ranks:
        assert sorted(r["images"]) == sorted(want) == ["both_seed0",
                                                       "both_seed3"]
        for k in want:
            diff = np.abs(r["images"][k].astype(int) - want[k].astype(int))
            assert diff.max() <= 1, k
            rep = r["image_report"][k]
            np.testing.assert_allclose(
                rep["latents"].numpy(),
                report["images"][k]["latents"].numpy(), atol=1e-4, rtol=0)
            assert rep["model_reduced_bytes"] > 0
            assert rep["kernel_launches"] == report["images"][k][
                "kernel_launches"]
    assert os.listdir(root / "out0") == ["both_seed0.png"]
    assert ranks[1]["paths"] == [] and not os.path.exists(root / "out1")


# ----------------------------------------------------- four processes

DPTP = IMAGE + ["--dp", "2", "--tp", "2", "--seeds", "0", "5", "7"]


def _worker4(rank, root):
    join_group(os.path.join(root, "store"), 4, rank)
    report = {}
    images = infer.generate(infer.build_parser().parse_args(DPTP), report)
    torch.save({"images": images, "jobs": sorted(report["images"])},
               os.path.join(root, f"r{rank}.pt"))


def test_infer_dp2_tp2_gives_the_one_process_images(tmp_path):
    spawn(_worker4, (str(tmp_path),), nprocs=4)
    ranks = [torch.load(tmp_path / f"r{r}.pt", weights_only=False)
             for r in range(4)]
    want = infer.generate(infer.build_parser().parse_args(
        IMAGE + ["--seeds", "0", "5", "7"]))
    # ranks 0 and 1 (data row 0) serve seeds 0 and 7, ranks 2 and 3 seed 5
    assert [r["jobs"] for r in ranks] == [["both_seed0", "both_seed7"]] * 2 \
        + [["both_seed5"]] * 2
    for r in ranks:
        assert sorted(r["images"]) == sorted(want)
        for k in want:
            assert np.abs(r["images"][k].astype(int)
                          - want[k].astype(int)).max() <= 1, k
