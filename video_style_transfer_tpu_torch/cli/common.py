"""Shared CLI runtime: device selection, model assembly, text
conditioning and VAE-encoded training latents (per frame, from the
posterior moments of a fixed image set, or through the per-frame
posterior-moment cache of video training).

Two sources of weights:

- a diffusers-layout SDXL directory (``utils/hf_convert.load_sdxl``),
  with the CLIP tokenizers read from its ``tokenizer/`` and
  ``tokenizer_2/``;
- none: every model is drawn from a seed (full width, or the tiny
  configs with ``smoke``) and every prompt becomes seeded token ids
  (stable across processes: derived from a CRC of the text), which then
  run through the real CLIP encoders.
"""
from __future__ import annotations

import os
import zlib
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from video_style_transfer_tpu_torch.config import (
    CLIPConfig, UNetConfig, VAEConfig)
from video_style_transfer_tpu_torch.models.clip import (
    encode_sdxl_prompt, init_clip)
from video_style_transfer_tpu_torch.models.layers import Init
from video_style_transfer_tpu_torch.models.unet import init_unet
from video_style_transfer_tpu_torch.models.vae import (
    init_vae_decoder, init_vae_encoder, vae_encode, vae_encode_moments)
from video_style_transfer_tpu_torch.pipelines.image import default_time_ids
from video_style_transfer_tpu_torch.pipelines.sampling import Conditioning

DEFAULT_NEGATIVE_PROMPT = (
    "watermark, lowres, low quality, blur, out of focus, grainy, "
    "jpeg artifacts, cropped, poorly lit, duplicate")


@dataclass
class ModelBundle:
    unet: Any
    unet_cfg: UNetConfig
    vae: Any
    vae_cfg: VAEConfig
    clip_l: Any
    clip_l_cfg: CLIPConfig
    clip_g: Any
    clip_g_cfg: CLIPConfig
    device: torch.device
    vae_scale_factor: int = 8
    vae_encoder: Any = None
    tokenizer: Any = None       # pads with EOS
    tokenizer_2: Any = None     # pads with 0
    seeded: bool = True         # weights drawn from a seed, not loaded


def kernel_launch_counts() -> dict:
    """Launches of every hand-written kernel in this process so far, by
    kernel name (each wrapper counts where it launches, nowhere else)."""
    from video_style_transfer_tpu_torch.ops import flash_attention as fa
    from video_style_transfer_tpu_torch.ops import geglu, layer_norm
    from video_style_transfer_tpu_torch.ops import temporal_attention as ta
    return {"flash_attention_fwd": fa.LAUNCHES,
            "geglu_projection": geglu.LAUNCHES,
            "temporal_attention": ta.LAUNCHES,
            "flash_attention_bwd": fa.BWD_LAUNCHES,
            "flash_attention_bwd_delta": fa.DELTA_LAUNCHES,
            "temporal_attention_bwd": ta.BWD_LAUNCHES,
            "layer_norm": layer_norm.LAUNCHES}


def launches_since(before: dict) -> dict:
    return {k: v - before[k] for k, v in kernel_launch_counts().items()}


def seeded_generator(seed: int) -> torch.Generator:
    """The noise of a seed is drawn on the CPU and moved to the device, so
    a seed gives the same sample on every device."""
    return torch.Generator().manual_seed(seed)


def add_distributed_flags(p, what: str):
    """The coordinator flags of a multi-process run (the JAX CLIs'),
    torchrun's environment standing in for any left unset."""
    p.add_argument("--coordinator_address", default=None,
                   help=f"host:port of process 0's rendezvous for a "
                        f"multi-process {what}, with --num_processes and "
                        f"--process_id (or torchrun's MASTER_ADDR, "
                        f"MASTER_PORT, WORLD_SIZE and RANK); process 0 "
                        f"writes every file, to an output directory all "
                        f"hosts share")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)


def setup_distributed(args, *, data: Optional[int] = 1, frame: int = 1,
                      model: int = 1, what: str):
    """Join the run's process group (parallel.distributed.init_distributed
    on the coordinator flags or torchrun's environment; a group that
    exists already is used as it is), pick this rank's device (bare
    ``cuda`` becomes ``cuda:LOCAL_RANK`` in a world of more than one;
    args.device is rewritten to it), check that the data x frame x model
    grid uses every process (data None: the processes `frame` and `model`
    leave, as the JAX trainers' --data_parallel 0), build it and meet at
    the first barrier. Returns (device, grid)."""
    from video_style_transfer_tpu_torch.parallel import distributed, mesh

    device = resolve_device(args.device)
    try:
        distributed.init_distributed(args.coordinator_address,
                                     args.num_processes, args.process_id,
                                     device=device)
    except ValueError as e:
        raise SystemExit(str(e))
    world = distributed.world_size()
    if world > 1 and device.type == "cuda" and device.index is None:
        device = torch.device("cuda", distributed.local_rank())
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    args.device = str(device)
    if data is None:
        data = max(world // (frame * model), 1)
    need = data * frame * model
    if need != world:
        if world == 1:
            raise SystemExit(f"{what} needs {need} processes; this "
                             f"run has one (launch them with torchrun "
                             f"--nproc_per_node, or the coordinator flags)")
        raise SystemExit(f"multi-process runs must use every device: "
                         f"{what} spans {need} of {world} processes")
    grid = mesh.create_mesh(data=data, frame=frame, model=model)
    # the first collective, before any rank goes its own way
    distributed.barrier("mesh_ready")
    if world > 1 and distributed.is_main_process():
        print(f"{what}: {data} x {frame} x {model} (data x frame x model) "
              f"grid of {world} processes", flush=True)
    return device, grid


def resolve_device(name: str) -> torch.device:
    """The requested device; asking for CUDA without a usable card is an
    error, never a silent move to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: CUDA is not available here "
                         f"(pass --device cpu to run the plain versions)")
    return dev


def model_configs(smoke: bool, motion: bool):
    """(UNet, VAE, CLIP-L, CLIP-bigG) configs. The tiny set is
    self-consistent: CLIP hidden sizes sum to the UNet's
    cross_attention_dim and bigG's projection fills its pooled slot."""
    if smoke:
        return (UNetConfig.tiny(use_motion_modules=motion), VAEConfig.tiny(),
                CLIPConfig.tiny(), CLIPConfig.tiny(projection_dim=32))
    return (UNetConfig.sdxl(use_motion_modules=motion), VAEConfig.sdxl(),
            CLIPConfig.sdxl_clip_l(), CLIPConfig.sdxl_big_g())


def tiny_checkpoint_configs(motion: bool = False):
    """The tiny (UNet, VAE, CLIP-L, CLIP-bigG) configs of a synthetic
    diffusers-layout checkpoint directory
    (``cli/verify_parity.make_synthetic_checkpoint``)."""
    return model_configs(True, motion)


def load_models(pretrained: Optional[str], *, smoke: bool = False,
                motion: bool = True, dtype=torch.bfloat16, seed: int = 0,
                device="cpu", encoder: bool = False,
                vae_path: Optional[str] = None, configs=None) -> ModelBundle:
    """UNet and CLIPs in `dtype`, the VAE decoder (and with `encoder` the
    VAE encoder) in fp32 (the reference keeps the VAE in fp32), on
    `device`: loaded from the diffusers-layout directory `pretrained`
    (`vae_path`: a separate VAE checkpoint; `configs`: the four configs
    of a checkpoint that is not SDXL-sized), or, without one, drawn from
    `seed`."""
    device = torch.device(device)
    if pretrained:
        from video_style_transfer_tpu_torch.data.tokenizer import (
            CLIPTokenizer)
        from video_style_transfer_tpu_torch.utils.hf_convert import load_sdxl

        loaded = load_sdxl(pretrained, dtype=dtype, with_motion=motion,
                           vae_dir=vae_path, configs=configs, device=device,
                           encoder=encoder)
        tok = tok2 = None
        tok_dir = os.path.join(pretrained, "tokenizer")
        tok2_dir = os.path.join(pretrained, "tokenizer_2")
        if os.path.isdir(tok_dir):
            tok = CLIPTokenizer.from_dir(tok_dir)
        if os.path.isdir(tok2_dir):
            tok2 = CLIPTokenizer.from_dir(tok2_dir, pad_token_id=0)
        (unet, ucfg), (vae, vcfg) = loaded["unet"], loaded["vae"]
        (clip_l, lcfg), (clip_g, gcfg) = loaded["clip_l"], loaded["clip_g"]
        return ModelBundle(
            unet, ucfg, vae, vcfg, clip_l, lcfg, clip_g, gcfg, device,
            vae_scale_factor=2 ** (len(vcfg.block_out_channels) - 1),
            vae_encoder=loaded["vae_encoder"], tokenizer=tok,
            tokenizer_2=tok2, seeded=False)
    ucfg, vcfg, lcfg, gcfg = model_configs(smoke, motion)
    return ModelBundle(
        unet=init_unet(Init(seed, device, dtype), ucfg), unet_cfg=ucfg,
        vae=init_vae_decoder(Init(seed + 1, device), vcfg),
        vae_cfg=vcfg,
        clip_l=init_clip(Init(seed + 2, device, dtype), lcfg),
        clip_l_cfg=lcfg,
        clip_g=init_clip(Init(seed + 3, device, dtype), gcfg),
        clip_g_cfg=gcfg, device=device,
        vae_scale_factor=2 ** (len(vcfg.block_out_channels) - 1),
        vae_encoder=(init_vae_encoder(Init(seed + 4, device), vcfg)
                     if encoder else None))


def prompt_token_ids(prompt: str, cfg: CLIPConfig, *, pad_with_eos: bool):
    """Seeded stand-in for the CLIP tokenizer: BOS (vocab-2), one random
    id per word, EOS (vocab-1), then padding (EOS for CLIP-L, 0 for bigG,
    as SDXL's two tokenizers pad). Returns (1, max_position_embeddings)
    int64 numpy."""
    length = cfg.max_position_embeddings
    bos, eos = cfg.vocab_size - 2, cfg.vocab_size - 1
    rng = np.random.default_rng(zlib.crc32(prompt.encode()))
    n = min(max(len(prompt.split()), 1), length - 2)
    ids = np.full((1, length), eos if pad_with_eos else 0, np.int64)
    ids[0, 0] = bos
    ids[0, 1:n + 1] = rng.integers(0, cfg.vocab_size - 2, n)
    ids[0, n + 1] = eos
    return ids


def encode_prompt(bundle: ModelBundle, prompt: str,
                  prompt_2: Optional[str] = None):
    """(embeds (1, 77, 2048), pooled (1, proj)) through both encoders.
    prompt_2 optionally feeds the second (bigG) encoder another text.
    Loaded weights need the directory's tokenizers: seeded token ids
    against real weights would be noise presented as a result."""
    dev = bundle.device
    if bundle.tokenizer is None:
        if not bundle.seeded:
            raise SystemExit(
                "no tokenizer/ found in the model directory; inference "
                "with loaded weights needs the CLIP tokenizers")
        ids_l = prompt_token_ids(prompt, bundle.clip_l_cfg,
                                 pad_with_eos=True)
        ids_g = prompt_token_ids(prompt_2 or prompt, bundle.clip_g_cfg,
                                 pad_with_eos=False)
        eos_l = bundle.clip_l_cfg.vocab_size - 1
        eos_g = bundle.clip_g_cfg.vocab_size - 1
    else:
        if bundle.tokenizer_2 is None:
            raise SystemExit("tokenizer/ present but tokenizer_2/ missing: "
                             "SDXL needs both CLIP tokenizers")
        ids_l = bundle.tokenizer(prompt)
        ids_g = bundle.tokenizer_2(prompt_2 or prompt)
        # the vocabulary's own EOS ids (49407 for both SDXL tokenizers)
        eos_l = bundle.tokenizer.eos_token_id
        eos_g = bundle.tokenizer_2.eos_token_id
    return encode_sdxl_prompt(bundle.clip_l, bundle.clip_l_cfg,
                              bundle.clip_g, bundle.clip_g_cfg,
                              torch.from_numpy(ids_l).to(dev),
                              torch.from_numpy(ids_g).to(dev),
                              eos_l=eos_l, eos_g=eos_g)


def make_conditioning(bundle: ModelBundle, prompt: str,
                      prompt_content: Optional[str] = None,
                      prompt_style: Optional[str] = None, *,
                      height: int, width: int,
                      prompt_2: Optional[str] = None,
                      prompt_content_2: Optional[str] = None,
                      prompt_style_2: Optional[str] = None) -> Conditioning:
    """Triple-stream conditioning: the combined prompt, and optionally a
    content and a style prompt for the UnZipLoRA branches (a missing
    stream falls back to the combined one). The ``*_2`` prompts feed the
    second encoder another text per stream."""
    emb, pooled = encode_prompt(bundle, prompt, prompt_2)
    emb_c = emb_s = None
    if prompt_content is not None:
        emb_c, _ = encode_prompt(bundle, prompt_content, prompt_content_2)
    if prompt_style is not None:
        emb_s, _ = encode_prompt(bundle, prompt_style, prompt_style_2)
    return Conditioning(ctx=(emb, emb_c, emb_s), pooled=pooled,
                        time_ids=default_time_ids(height, width, 1,
                                                  device=bundle.device))


def negative_conditioning(bundle: ModelBundle, negative_prompt: str, *,
                          height: int, width: int,
                          negative_prompt_2: Optional[str] = None,
                          negative_prompt_content: Optional[str] = None,
                          negative_prompt_content_2: Optional[str] = None,
                          negative_prompt_style: Optional[str] = None,
                          negative_prompt_style_2: Optional[str] = None
                          ) -> Conditioning:
    """Unconditional side of the CFG pair; streams without a negative of
    their own share the combined one."""
    emb, pooled = encode_prompt(bundle, negative_prompt, negative_prompt_2)
    emb_c = emb_s = emb
    if negative_prompt_content is not None:
        emb_c, _ = encode_prompt(bundle, negative_prompt_content,
                                 negative_prompt_content_2)
    if negative_prompt_style is not None:
        emb_s, _ = encode_prompt(bundle, negative_prompt_style,
                                 negative_prompt_style_2)
    return Conditioning(ctx=(emb, emb_c, emb_s), pooled=pooled,
                        time_ids=default_time_ids(height, width, 1,
                                                  device=bundle.device))


def load_unziplora(params, *, base: Optional[str], name: str = "unziplora",
                   content_path: Optional[str] = None,
                   style_path: Optional[str] = None,
                   content_weight_path: Optional[str] = None,
                   style_weight_path: Optional[str] = None):
    """Install a stage-1 artifact set into UNet params: `base`/`name` is
    the directory-plus-name convention ({name}_content/, {name}_style/,
    {name}_merger_{content,style}.pth); the explicit paths override it
    piece by piece. Returns (params, lora_state)."""
    from video_style_transfer_tpu_torch.lora import interop

    def at(flag, default):
        return flag if flag else os.path.join(base or "", default)

    weights = "pytorch_lora_weights.safetensors"
    return interop.import_state_dicts(
        params,
        interop.load_safetensors(os.path.join(
            at(content_path, f"{name}_content"), weights)),
        interop.load_safetensors(os.path.join(
            at(style_path, f"{name}_style"), weights)),
        interop.load_merger_pth(at(content_weight_path,
                                   f"{name}_merger_content.pth")),
        interop.load_merger_pth(at(style_weight_path,
                                   f"{name}_merger_style.pth")))


def _draw_eps(shape, n: int, generator: torch.Generator, device,
              rows=None):
    """n draws of shape `shape` from `generator` in order (one a frame,
    as every encoder here draws them), kept at positions `rows` (None:
    all), concatenated."""
    eps = [torch.randn(shape, generator=generator, device=device)
           for _ in range(n)]
    return torch.cat(eps if rows is None else [eps[k] for k in rows])


def _scaled(bundle: ModelBundle, moments, eps):
    """Scaled latents mean + exp(0.5 logvar) * eps on the bundle's
    device."""
    mean, logvar = (m.to(bundle.device) for m in moments)
    return (mean + torch.exp(0.5 * logvar) * eps) \
        * bundle.vae_cfg.scaling_factor


def encode_latents(bundle: ModelBundle, images, generator: torch.Generator,
                   rows=None):
    """(N, H, W, 3) in [-1, 1] -> scaled latents (N, H/f, W/f, 4), each a
    draw mean + std * eps of the posterior: fp32 encode one frame per call
    (a whole 8-frame 1024^2 clip at once holds far more activation
    memory). rows: the positions to encode (a rank's frames of a global
    batch, parallel.mesh.Grid.positions); eps is drawn for all N in
    order, so each keeps the draw one process gives it."""
    shape = (1, images.shape[1] // bundle.vae_scale_factor,
             images.shape[2] // bundle.vae_scale_factor,
             bundle.vae_cfg.latent_channels)
    keep = range(images.shape[0]) if rows is None else rows
    eps = _draw_eps(shape, images.shape[0], generator, images.device, rows)
    out = [vae_encode(bundle.vae_encoder, bundle.vae_cfg,
                      images[k:k + 1].float(), eps[i:i + 1])
           for i, k in enumerate(keep)]
    return torch.cat(out)


def encode_latent_moments(bundle: ModelBundle, images):
    """(N, H, W, 3) in [-1, 1] (host array or tensor) -> the posterior
    (mean, logvar), unscaled, (N, H/f, W/f, C) each on the bundle's
    device: fp32 encode, one image per call, as encode_latents runs it.
    The trainers encode their fixed image sets once and draw from these
    every step (sample_scaled_latents)."""
    means, logvars = [], []
    with torch.no_grad():
        for k in range(len(images)):
            x = torch.as_tensor(images[k:k + 1]).to(bundle.device,
                                                     torch.float32)
            mean, logvar = vae_encode_moments(bundle.vae_encoder,
                                              bundle.vae_cfg, x)
            means.append(mean)
            logvars.append(logvar)
    return torch.cat(means), torch.cat(logvars)


def sample_scaled_latents(bundle: ModelBundle, moments, idx,
                          generator: torch.Generator):
    """Scaled latents mean + exp(0.5 logvar) * eps of rows `idx` (None:
    every row) of posterior moments, on the bundle's device. eps is drawn
    from `generator` one (1, h, w, C) row at a time, in the order and
    shape encode_latents and LatentMomentCache draw theirs, so one
    generator state gives the same latents on every route."""
    mean, logvar = moments
    if idx is not None:
        mean, logvar = mean[idx], logvar[idx]
    eps = _draw_eps((1,) + tuple(mean.shape[1:]), mean.shape[0], generator,
                    bundle.device)
    return _scaled(bundle, (mean, logvar), eps)


class LatentMomentCache:
    """Per-frame VAE posterior moments for video training (the JAX
    package's cli/common.py LatentMomentCache).

    Consecutive-start clips of one video share all but one frame, and a
    frame's posterior moments (mean, logvar) do not change, so they are
    kept in host memory keyed by the frame's (video_idx, frame_idx); only
    the draw ``mean + exp(0.5 logvar) * eps`` happens per step, on the
    device. Its eps are drawn from the caller's generator in the order
    and shape ``encode_latents`` draws them (one (1, h, w, C) draw per
    frame), so the same generator state gives the same latents with the
    cache as without it.

    The encoder runs in fp32, `chunk` missing frames a call, and encodes
    an id missing twice from one batch once. An entry is 0.5 MB at 1024²;
    past `max_entries` a frame is encoded and not kept. `misses` counts
    the frames encoded, `hits` the frames served without an encode."""

    def __init__(self, bundle: ModelBundle, max_entries: int = 4096,
                 chunk: int = 1):
        self.bundle = bundle
        self.max_entries = max_entries
        self.chunk = chunk
        self._cache: Dict[Any, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._cache)

    @torch.no_grad()
    def moments(self, frames_flat, ids_flat):
        """(mean, logvar) on the host, (N, h, w, C) each, of frames
        (N, H, W, 3) in [-1, 1] (host array or tensor) with ids
        `ids_flat`."""
        fresh = {}
        seen, missing = set(), []
        for k, fid in enumerate(ids_flat):
            if fid not in self._cache and fid not in seen:
                seen.add(fid)
                missing.append(k)
        self.misses += len(missing)
        self.hits += len(ids_flat) - len(missing)
        for s in range(0, len(missing), self.chunk):
            grp = missing[s:s + self.chunk]
            x = torch.as_tensor(frames_flat[grp]).to(self.bundle.device,
                                                     torch.float32)
            mean, logvar = vae_encode_moments(self.bundle.vae_encoder,
                                              self.bundle.vae_cfg, x)
            mean, logvar = mean.cpu(), logvar.cpu()
            for j, k in enumerate(grp):
                fresh[ids_flat[k]] = (mean[j], logvar[j])
                if len(self._cache) < self.max_entries:
                    self._cache[ids_flat[k]] = (mean[j], logvar[j])
        got = [self._cache[fid] if fid in self._cache else fresh[fid]
               for fid in ids_flat]
        return (torch.stack([m for m, _ in got]),
                torch.stack([lv for _, lv in got]))

    @torch.no_grad()
    def latents(self, frames, ids, generator: torch.Generator, rows=None):
        """frames (B, F, H, W, 3) in [-1, 1], ids[b][j] the id of frame j
        of clip b -> scaled latents (B*F, h, w, C) on the bundle's
        device. rows: the flat positions b*F + j to keep (a rank's clips
        and frames, parallel.mesh.Grid.positions): only those are encoded
        (and so cached: a rank's cache holds its own frames), eps is
        drawn for all B*F."""
        flat = frames.reshape((-1,) + tuple(frames.shape[2:]))
        fids = [fid for clip in ids for fid in clip]
        kept = fids
        if rows is not None:
            flat, kept = flat[list(rows)], [fids[k] for k in rows]
        mean, logvar = self.moments(flat, kept)
        eps = _draw_eps((1,) + tuple(mean.shape[1:]), len(fids), generator,
                        self.bundle.device, rows)
        return _scaled(self.bundle, (mean, logvar), eps)
