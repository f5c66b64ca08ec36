"""The PyTorch port's loaders against the JAX package's, on the CPU: the
safetensors container against the ``safetensors`` package, LoRA artifact
dicts, motion checkpoints and a synthetic SDXL directory against the JAX
converters (same numpy inputs; dicts and token ids exactly, converted
trees exactly), the full-width key inventories against the golden
fixtures without allocating a weight, and the CLIP tokenizer against the
JAX one (which uses the ``regex`` package) on a fixed list and on
hypothesis-drawn text.
"""
import ast
import os
import warnings

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from video_style_transfer_tpu.cli import common as jcommon
from video_style_transfer_tpu.cli import verify_parity as jverify
from video_style_transfer_tpu.config import UNetConfig as JUNetConfig
from video_style_transfer_tpu.data import tokenizer as jtok
from video_style_transfer_tpu.lora import interop as jinterop
from video_style_transfer_tpu.lora import surgery as jsurgery
from video_style_transfer_tpu.models import unet as junet
from video_style_transfer_tpu.utils import hf_convert as jhf
from video_style_transfer_tpu.utils import motion_convert as jmotion
from video_style_transfer_tpu_torch.cli import common as tcommon
from video_style_transfer_tpu_torch.cli import verify_parity as tverify
from video_style_transfer_tpu_torch.config import (
    CLIPConfig, UNetConfig, VAEConfig)
from video_style_transfer_tpu_torch.data import tokenizer as ttok
from video_style_transfer_tpu_torch.lora import interop as tinterop
from video_style_transfer_tpu_torch.lora import surgery as tsurgery
from video_style_transfer_tpu_torch.models.layers import Init, MetaInit
from video_style_transfer_tpu_torch.models.unet import init_unet
from video_style_transfer_tpu_torch.models.vae import (
    init_vae_decoder, init_vae_encoder)
from video_style_transfer_tpu_torch.training.stage2 import iter_leaves
from video_style_transfer_tpu_torch.utils import checkpoint as tcheckpoint
from video_style_transfer_tpu_torch.utils import convert
from video_style_transfer_tpu_torch.utils import hf_convert as thf
from video_style_transfer_tpu_torch.utils import motion_convert as tmotion
from video_style_transfer_tpu_torch.utils import safetensors_io as sio

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _same_trees(got, want):
    """Two port trees with bitwise equal leaves at equal paths."""
    a, b = dict(iter_leaves(got)), dict(iter_leaves(want))
    assert set(a) == set(b)
    for path, t in a.items():
        assert t.dtype == b[path].dtype and torch.equal(t, b[path]), path


def _same_dicts(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


# --------------------------------------------------------- safetensors

def _numpy_tensors():
    rng = np.random.default_rng(0)
    return {"f32": rng.normal(size=(3, 4)).astype(np.float32),
            "f16": rng.normal(size=(5,)).astype(np.float16),
            "i64": np.arange(6, dtype=np.int64).reshape(2, 3),
            "scalar": np.array(3.0, np.float32),
            "empty": np.zeros((0, 4), np.float32),
            "bool": np.array([True, False])}


@pytest.mark.parametrize("direction", ["ours_to_theirs", "theirs_to_ours"])
def test_safetensors_round_trip(tmp_path, direction):
    from safetensors.numpy import load_file, save_file
    want = _numpy_tensors()
    path = str(tmp_path / "t.safetensors")
    if direction == "ours_to_theirs":
        sio.save_file(want, path, metadata={"format": "pt"})
        got = load_file(path)
    else:
        save_file(want, path)
        got = sio.load_numpy(path)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape
        np.testing.assert_array_equal(got[k], v)


def test_safetensors_bf16_and_casts(tmp_path):
    from safetensors.torch import load_file, save_file
    t = {"w": torch.randn(4, 4, generator=torch.Generator().manual_seed(0))
         .to(torch.bfloat16), "ids": torch.arange(3)}
    ours, theirs = str(tmp_path / "a.st"), str(tmp_path / "b.st")
    sio.save_file(t, ours)
    save_file(t, theirs)
    for got in (load_file(ours), sio.load_file(theirs)):
        assert torch.equal(got["w"], t["w"]) and torch.equal(got["ids"],
                                                             t["ids"])
    cast = sio.load_file(ours, dtype=torch.float32)
    assert cast["w"].dtype == torch.float32
    assert cast["ids"].dtype == torch.int64   # integers keep their dtype
    assert sio.load_numpy(ours)["w"].dtype == np.float32


def test_safetensors_refuses_damaged_files(tmp_path):
    path = str(tmp_path / "t.safetensors")
    sio.save_file({"x": np.ones((4, 4), np.float32)}, path)
    blob = open(path, "rb").read()
    open(path, "wb").write(blob[:-8])
    with pytest.raises(ValueError, match="truncated"):
        sio.load_file(path)
    open(path, "wb").write(b"abc")
    with pytest.raises(ValueError, match="too short"):
        sio.load_file(path)


# ------------------------------------------------------- LoRA artifacts

@pytest.fixture(scope="module")
def lora_pair():
    """A JAX tiny UNet with seeded UnZipLoRA factors, non-trivial mergers
    and one active column mask, and the same as port trees."""
    ju = junet.init_unet(jax.random.PRNGKey(0), JUNetConfig.tiny())
    jp, jstate = jsurgery.insert_unziplora(ju, jax.random.PRNGKey(1), rank=4)
    rng = np.random.default_rng(2)
    path = ("down_blocks", 1, "attentions", 0, "transformer_blocks", "attn1",
            "to_q")
    lora = jsurgery.tree_get(jp, path + ("lora",))
    merge = jnp.asarray(rng.normal(size=lora["merge_content"].shape),
                        jnp.float32)
    jp = jsurgery.tree_set(jp, path + ("lora", "merge_content"), merge)
    ent = dict(jsurgery.tree_get(jstate, path))
    ent["use_mask_style"] = jnp.ones_like(ent["use_mask_style"])
    ent["mask_style"] = jnp.asarray(
        rng.random(ent["mask_style"].shape) > 0.5)
    jstate = jsurgery.tree_set(jstate, path, ent)
    return (ju, jp, jstate, convert.convert_tree(jp),
            convert.convert_lora_state(jstate))


@pytest.mark.parametrize("branch", ["content", "style"])
def test_export_state_dicts_match_jax(lora_pair, branch):
    _, jp, jstate, tp, tstate = lora_pair
    want_lora, want_merger = jinterop.export_state_dicts(jp, jstate, branch)
    got_lora, got_merger = tinterop.export_state_dicts(tp, tstate, branch)
    assert len(want_lora) == 2 * 32
    _same_dicts(got_lora, want_lora)
    _same_dicts(got_merger, want_merger)


def test_import_state_dicts_match_jax(lora_pair, tmp_path):
    ju, jp, jstate, tp, tstate = lora_pair
    paths = tcheckpoint.export_stage1_artifacts(str(tmp_path), "unziplora",
                                                tp, tstate)
    sds = [tinterop.load_safetensors(paths["content"]),
           tinterop.load_safetensors(paths["style"]),
           tinterop.load_merger_pth(paths["merger_content"]),
           tinterop.load_merger_pth(paths["merger_style"])]
    # the files hold what the JAX exporter gives
    for branch, lora_sd, merger_sd in (("content", sds[0], sds[2]),
                                       ("style", sds[1], sds[3])):
        want = jinterop.export_state_dicts(jp, jstate, branch)
        _same_dicts(lora_sd, want[0])
        _same_dicts(merger_sd, want[1])
    jnew, jst = jinterop.import_state_dicts(ju, *sds)
    base = convert.convert_tree(ju)
    before = dict(iter_leaves(base))
    tnew, tst = tcommon.load_unziplora(base, base=str(tmp_path))
    _same_trees(tnew, convert.convert_tree(jnew))
    _same_trees(tst, convert.convert_lora_state(jst))
    # the base tree is untouched and shares its weights with the new one
    after = dict(iter_leaves(base))
    assert set(after) == set(before)
    assert all(after[k] is before[k] for k in before)
    assert tnew["conv_in"]["weight"] is base["conv_in"]["weight"]


@pytest.mark.parametrize("branch", ["content", "style"])
def test_import_single_lora_matches_jax(lora_pair, branch):
    ju, jp, jstate, _, _ = lora_pair
    sd, _ = jinterop.export_state_dicts(jp, jstate, branch)
    jnew, jst = jinterop.import_single_lora(ju, sd, branch=branch, scale=0.7)
    tnew, tst = tinterop.import_single_lora(convert.convert_tree(ju), sd,
                                            branch=branch, scale=0.7)
    _same_trees(tnew, convert.convert_tree(jnew))
    _same_trees(tst, convert.convert_lora_state(jst))


def test_import_refuses_incomplete_artifacts(lora_pair):
    _, _, _, tp, tstate = lora_pair
    content, _ = tinterop.export_state_dicts(tp, tstate, "content")
    style, _ = tinterop.export_state_dicts(tp, tstate, "style")
    base = init_unet(Init(0), UNetConfig.tiny())
    broken = dict(style)
    broken.pop(next(k for k in broken if k.endswith("up.weight")))
    with pytest.raises(ValueError, match="incomplete LoRA artifact"):
        tinterop.import_state_dicts(base, content, broken)
    # a stack covered for one of its two layers only
    cfg = UNetConfig.tiny(transformer_layers_per_block=(1, 2))
    deep = init_unet(Init(0), cfg)
    full, st_ = tsurgery.insert_unziplora(tsurgery.copy_structure(deep),
                                          Init(1), rank=4)
    c, _ = tinterop.export_state_dicts(full, st_, "content")
    s, _ = tinterop.export_state_dicts(full, st_, "style")
    tinterop.import_state_dicts(deep, c, s)

    def drop(sd):
        return {k: v for k, v in sd.items()
                if "down_blocks.1.attentions.0.transformer_blocks.0." not in k}
    with pytest.raises(ValueError, match="covers 1 of 2 layers"):
        tinterop.import_state_dicts(deep, drop(c), drop(s))


# ---------------------------------------------------- motion checkpoints

@pytest.fixture(scope="module")
def motion_pair():
    """A JAX tiny motion UNet with a temporal LoRA whose b is not zero,
    and the same as a port tree."""
    cfg = JUNetConfig.tiny(use_motion_modules=True)
    ju = junet.init_unet(jax.random.PRNGKey(0), cfg)
    jp = jsurgery.insert_temporal_lora(ju, jax.random.PRNGKey(1), rank=4)

    def bump(path, leaf):
        if getattr(path[-1], "key", None) == "b" and any(
                getattr(k, "key", None) == "tlora" for k in path):
            return jax.random.normal(jax.random.PRNGKey(leaf.size),
                                     leaf.shape) * 0.05
        return leaf
    jp = jax.tree_util.tree_map_with_path(bump, jp)
    return jp, convert.convert_tree(jp)


@pytest.mark.parametrize("include_pe", [True, False])
def test_motion_export_matches_jax(motion_pair, include_pe):
    jp, tp = motion_pair
    want = jmotion.export_motion_state_dict(jp, include_pe=include_pe)
    got = tmotion.export_motion_state_dict(tp, include_pe=include_pe)
    assert set(got) == set(want)
    assert any(k.endswith("pos_embed.pe") for k in got) == include_pe
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0,
                                   err_msg=k)
    # the fold changed the attention weights and left the input tree as is
    plain = tmotion.export_motion_state_dict(tp, fold_tlora=False,
                                             include_pe=False)
    key = next(k for k in plain if k.endswith("attn1.to_q.weight"))
    assert np.abs(plain[key] - got[key]).max() > 1e-4
    assert any(path[-2] == "tlora" for path, _ in iter_leaves(tp))


@pytest.mark.parametrize("fmt", ["safetensors", "pth"])
def test_motion_checkpoint_round_trip(motion_pair, tmp_path, fmt):
    jp, tp = motion_pair
    out = str(tmp_path / "ckpt" / f"motion_modules.{fmt}")
    sd = tcheckpoint.export_motion_checkpoint(out, tp)
    assert tmotion.find_motion_checkpoint(str(tmp_path / "ckpt")) == out
    loaded = tmotion.load_motion_checkpoint(str(tmp_path / "ckpt"))
    _same_dicts(loaded, sd)
    assert any(k.endswith("pos_embed.pe") for k in loaded) == (fmt == "pth")
    # the JAX importer and the port's read the file to the same tree
    cfg = JUNetConfig.tiny(use_motion_modules=True)
    jfresh = junet.init_unet(jax.random.PRNGKey(9), cfg)
    want = jmotion.import_motion_state_dict(
        jfresh, jmotion.load_motion_checkpoint(out))
    fresh = convert.convert_tree(jfresh)
    got = tmotion.import_motion_state_dict(fresh, loaded)
    _same_trees(got, convert.convert_tree(want))
    assert got["conv_in"]["weight"] is fresh["conv_in"]["weight"]
    # and it holds the folded weights
    folded = tmotion.fold_temporal_lora(tp)
    for path, t in iter_leaves(folded):
        if "motion_modules" in path:
            assert torch.equal(t, tsurgery.tree_get(got, path)), path


def test_motion_import_refuses_other_positional_encoding(motion_pair):
    _, tp = motion_pair
    sd = tmotion.export_motion_state_dict(tp)
    key = next(k for k in sd if k.endswith("pos_embed.pe"))
    sd[key] = sd[key] + 0.01
    with pytest.raises(ValueError, match="positional-encoding"):
        tmotion.import_motion_state_dict(tp, sd)
    with pytest.raises(KeyError, match="motion_modules"):
        tmotion.import_motion_state_dict(tp, {"conv_in.weight": sd[key]})
    with pytest.raises(FileNotFoundError):
        tmotion.load_motion_checkpoint("no/such/checkpoint")


# ------------------------------------------- a diffusers-layout directory

def _torch_bundle(loaded):
    return {"unet": loaded["unet"][0], "vae": loaded["vae"][0],
            "vae_encoder": loaded["vae_encoder"],
            "clip_l": loaded["clip_l"][0], "clip_g": loaded["clip_g"][0]}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_load_sdxl_matches_jax(tmp_path, writer):
    make = (jverify if writer == "jax" else tverify).make_synthetic_checkpoint
    ckpt = make(str(tmp_path / "ckpt"))
    jl = jhf.load_sdxl(ckpt, dtype=jnp.float32,
                       configs=jcommon.tiny_checkpoint_configs())
    tl = _torch_bundle(thf.load_sdxl(
        ckpt, dtype=torch.float32, encoder=True,
        configs=tcommon.tiny_checkpoint_configs()))
    _same_trees(tl["unet"], convert.convert_tree(jl["unet"][0]))
    _same_trees(tl["vae"], convert.convert_vae_decoder(jl["vae"][0]))
    _same_trees(tl["vae_encoder"], convert.convert_vae_encoder(jl["vae"][0]))
    _same_trees(tl["clip_l"], convert.convert_tree(jl["clip_l"][0]))
    _same_trees(tl["clip_g"], convert.convert_tree(jl["clip_g"][0]))


def test_load_models_from_directory(tmp_path):
    ckpt = tverify.make_synthetic_checkpoint(str(tmp_path / "ckpt"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # nothing unexpected in the files
        bundle = tcommon.load_models(
            ckpt, motion=True, dtype=torch.float32,
            configs=tcommon.tiny_checkpoint_configs(motion=True))
    assert not bundle.seeded and bundle.vae_scale_factor == 2
    assert bundle.tokenizer.pad_token_id == bundle.tokenizer.eos_token_id
    assert bundle.tokenizer_2.pad_token_id == 0
    # the motion modules an SDXL UNet file lacks are zeros
    mm = bundle.unet["down_blocks"][0]["motion_modules"][0]
    assert float(mm["proj_out"]["weight"].abs().max()) == 0.0
    # token ids and embeddings as the JAX bundle of the same directory
    jb = jcommon.load_models(ckpt, dtype=jnp.float32,
                             configs=jcommon.tiny_checkpoint_configs())
    prompt = "A dog's portrait, 2 cats & watercolor"
    np.testing.assert_array_equal(bundle.tokenizer(prompt),
                                  jb.tokenizer(prompt))
    np.testing.assert_array_equal(bundle.tokenizer_2(prompt),
                                  jb.tokenizer_2(prompt))
    jemb, jpool = jcommon.encode_prompt(jb, prompt, "another text")
    emb, pool = tcommon.encode_prompt(bundle, prompt, "another text")
    np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), atol=2e-5)
    np.testing.assert_allclose(pool.numpy(), np.asarray(jpool), atol=2e-5)
    # loaded weights without tokenizers refuse to fake the prompt
    bundle.tokenizer = None
    with pytest.raises(SystemExit, match="tokenizer"):
        tcommon.encode_prompt(bundle, prompt)
    with pytest.raises(FileNotFoundError, match="no unet/"):
        tcommon.load_models(str(tmp_path), dtype=torch.float32)


# ------------------------------------------------------- key inventories

def _fixture(name):
    required = {}
    with open(os.path.join(FIXTURES, name)) as f:
        for ln in f:
            ln = ln.strip()
            if ln and not ln.startswith("OPTIONAL:"):
                key, shape = ln.split("\t")
                required[key] = tuple(ast.literal_eval(shape))
    return required


def _full_width_shapes(which):
    if which == "sdxl_unet":
        return thf.state_dict_shapes(init_unet(MetaInit(), UNetConfig.sdxl()))
    if which == "motion_adapter_sdxl_beta":
        template = init_unet(MetaInit(),
                             UNetConfig.sdxl(use_motion_modules=True))
        got = thf.state_dict_shapes(template,
                                    select=lambda p: "motion_modules" in p)
        assert set(got) == thf.state_dict_keys(
            template, select=lambda p: "motion_modules" in p)
        return got
    if which == "sdxl_vae":
        template = init_vae_decoder(MetaInit(), VAEConfig.sdxl())
        template.update(init_vae_encoder(MetaInit(), VAEConfig.sdxl()))
        return thf.state_dict_shapes(template)
    cfg = (CLIPConfig.sdxl_clip_l() if which == "clip_l"
           else CLIPConfig.sdxl_big_g())
    return thf.clip_source_shapes(cfg)


@pytest.mark.parametrize("which", ["sdxl_unet", "sdxl_vae", "clip_l",
                                   "clip_g", "motion_adapter_sdxl_beta"])
def test_full_width_key_inventory(which, monkeypatch):
    # key names and shapes come from a tree on the meta device: building
    # it must not allocate a single weight
    def refuse(*a, **kw):
        raise AssertionError("the inventory allocated a weight")
    monkeypatch.setattr(Init, "uniform", refuse)
    monkeypatch.setattr(Init, "normal", refuse)
    assert _full_width_shapes(which) == _fixture(f"keys_{which}.txt")


# ------------------------------------------------------------- tokenizer

def _byte_vocab():
    syms = list(jtok.bytes_to_unicode().values())
    vocab = {}
    for s in syms:
        vocab[s] = len(vocab)
    for s in syms:
        vocab[s + "</w>"] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    return vocab


@pytest.fixture(scope="module")
def tokenizers():
    """(JAX tokenizer on its Python BPE loop, the port's) over the
    synthetic byte-level vocabulary plus a few merges."""
    vocab = _byte_vocab()
    merges = [("t", "h"), ("th", "e</w>"), ("a", "n"), ("an", "d</w>"),
              ("i", "n"), ("in", "g</w>"), ("h", "o"), ("ho", "r")]
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    j = jtok.CLIPTokenizer(vocab, merges)
    j._native = None
    return j, ttok.CLIPTokenizer(vocab, merges)


PROMPTS = [
    "A horse's mane; it's the dog's, we're they've I'm you'll he'd",
    "3 cats, 42 dogs & 1,000.5 birds!!!",
    "café déjà vu naïve Ünïcode straße "
    "ſtraße it'ſ",
    "日本語のテキスト 漢字 "
    "١٢٣ ② Ⅷ",
    "emoji \U0001f434\U0001f3a8 <|startoftext|> <|endoftext|> "
    "<|ENDOFTEXT|> <|ſtartoftext|>",
    "&amp;lt;b&amp;gt; &quot;quoted&quot; &#39;s &amp;amp; &nbsp;x",
    "  multiple   spaces\n\ttabs nbsp　wide \x1f unit ",
    "the horse and the thing " * 30,
    "!'s ''ll <|x <| '",
    "",
]


@pytest.mark.parametrize("prompt", PROMPTS,
                         ids=[f"p{i}" for i in range(len(PROMPTS))])
def test_tokenizer_matches_jax(tokenizers, prompt):
    j, t = tokenizers
    ids = t(prompt)
    assert ids.shape == (1, 77)
    np.testing.assert_array_equal(ids, j(prompt))
    np.testing.assert_array_equal(
        t(prompt, truncation=False, padding="longest"),
        j(prompt, truncation=False, padding="longest"))
    np.testing.assert_array_equal(t([prompt, "a"], max_length=16),
                                  j([prompt, "a"], max_length=16))
    assert t.decode(ids[0]) == j.decode(ids[0])


def test_tokenizer_refuses_overlong_rows(tokenizers):
    _, t = tokenizers
    with pytest.raises(ValueError, match="exceeds max_length"):
        t("word " * 100, truncation=False)


def test_tokenizer_from_dir_pads_as_sdxl(tmp_path):
    ckpt = tverify.make_synthetic_checkpoint(str(tmp_path / "ckpt"))
    t1 = ttok.CLIPTokenizer.from_dir(os.path.join(ckpt, "tokenizer"))
    t2 = ttok.CLIPTokenizer.from_dir(os.path.join(ckpt, "tokenizer_2"),
                                     pad_token_id=0)
    j1 = jtok.CLIPTokenizer.from_dir(os.path.join(ckpt, "tokenizer"))
    a, b = t1("a dog")[0], t2("a dog")[0]
    np.testing.assert_array_equal(a, j1("a dog")[0])
    assert a[-1] == t1.eos_token_id and b[-1] == 0
    np.testing.assert_array_equal(a[:6], b[:6])
    assert a[6] == t1.eos_token_id and b[6] == 0


@settings(max_examples=300, deadline=None)
@given(st.text(alphabet=st.characters(exclude_categories=("Cs", "Cn")),
               max_size=40))
def test_pre_tokenizer_matches_pattern_on_any_text(text):
    # the pattern itself, with the regex package, against the scanner
    import regex
    pat = regex.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
        r"""|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""", regex.IGNORECASE)
    assert ttok.pre_tokenize(text.lower()) == pat.findall(text.lower())


@settings(max_examples=200, deadline=None)
@given(st.text(alphabet=st.sampled_from(
    list("'stTrevmldLSſ<|>startofendx !1a&;#39")), max_size=30))
def test_tokenizer_matches_jax_near_the_literals(tokenizers, text):
    j, t = tokenizers
    np.testing.assert_array_equal(t(text), j(text))
