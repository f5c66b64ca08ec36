"""K1: flash-attention forward and K4: its backward
(csrc/flash_attention_bwd.cu), each beside its plain PyTorch version.

K1 replaces the JAX package's ops/flash_attention.py Pallas kernels
`_attn_kernel_packed_single` / `_attn_kernel_packed` (and, at head dims
the TPU cannot pack such as d=192, 320 and 448, `_attn_kernel`); K4
replaces `_dqkv_kernel` / `_dq_kernel` + `_dkv_kernel`. K1 has three
routes, named by `route`: every bf16 head dim runs on wgmma with TMA
loads ("wgmma": csrc/flash_attention_sm90.cu at d = 64, 128, 192 and
256; csrc/flash_attention_wide.cu at d = 320, 384, 448 and 512, the VAE's
mid-block attention under --vae_dtype bfloat16, with O split by columns
across two consumer warpgroups); fp32 at d = 64 (every UNet
self-attention under --mixed_precision no) on the tensor cores at
3xTF32 ("tf32x3": csrc/flash_attention_tf32.cu, mma.sync with each
operand split into two TF32 halves, three products a product); every
other fp32 head dim (d = 512: the VAE's mid-block attention; 128-448 on
no path) on FP32 FMA register tiles fed by TMA, one kernel template on
d ("fma": csrc/flash_attention_f32.cu; `fma_tiles` mirrors its per-d
choices). On the H100 all are bound by tensor-core (bf16, TF32) or FMA
(fp32) throughput; see the sources for their designs. Where a grid of
the FMA route or of the wide kernel would leave the card's last wave
emptier, they split the kv walk (`kv_splits`) and a combine kernel
merges the parts. K4 takes every head dim K1 takes, on four routes named
by `bwd_route`: bf16 at d = 64 on wgmma with TMA loads ("wgmma"), fp32 at
d = 64 on the 3xTF32 route's dk/dv and dq kernels ("tf32x3"), and at d =
128-512 the same two-kernel form with D split (`bwd_plan`): bf16 on wgmma
with TMA loads, D across the blocks of a cluster ("wgmma_sliced":
csrc/flash_attention_bwd_sliced.cu), fp32 at 3xTF32 on TF32 wgmma, D
across the blocks of a cluster too ("tf32x3_sliced":
csrc/flash_attention_bwd_sliced_tf32.cu) -- the VAE's mid-block
attention (d = 512) under a gradient. Its delta = rowsum(dO * O) is a
kernel of its own. The TPU's head packing, MXU row-sum and block tuning
have no counterpart:
the kernels read (B, S, H, D) strided views, so the fused (B, S, 3*H*D)
projection is consumed in place.

Every call goes through one ``torch.autograd.Function`` that saves q, k,
v, the output and the lse (the JAX residuals). A CUDA tensor launches
the kernels or raises; a CPU tensor takes the plain versions.
"""
from __future__ import annotations

import math
import struct

import torch

from video_style_transfer_tpu_torch.ops import cuda_build
from video_style_transfer_tpu_torch.utils import tracing

# launches of the CUDA kernels in this process (the plain versions and
# refused calls do not count): LAUNCHES the forward (K1; one per call,
# a split kv walk's combine included), split by route in ROUTE_LAUNCHES,
# of which WIDE_LAUNCHES took the wgmma route's wide kernel (bf16 d >= 320),
# BWD_LAUNCHES the backward (K4; one per backward call, which runs its
# dk/dv and its dq kernel), split by route in BWD_ROUTE_LAUNCHES,
# DELTA_LAUNCHES K4's delta kernel
LAUNCHES = 0
ROUTE_LAUNCHES = {"wgmma": 0, "tf32x3": 0, "fma": 0}
WIDE_LAUNCHES = 0
BWD_LAUNCHES = 0
BWD_ROUTE_LAUNCHES = {"wgmma": 0, "tf32x3": 0, "wgmma_sliced": 0,
                      "tf32x3_sliced": 0}
DELTA_LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# one K1 call's arguments, packed for its C entry point (one argument to
# marshal instead of 25; csrc/flash_attention.cuh: FwdCall) in three
# parts: the q, k, v, out, lse and split-buffer pointers and the stream;
# the layout (q's, k's and v's (batch, seq, head) strides, the device,
# dtype, head dim, B, Sq, Sk, H and kv splits), packed once a layout;
# the scale
_FWD_POINTERS = struct.Struct("<7Q")
_FWD_LAYOUT = struct.Struct("<9q8i")
_FWD_SCALE = struct.Struct("<f")
HEAD_DIMS = (64, 128, 192, 256, 320, 384, 448, 512)
# fp32 head dims of the 3xTF32 route (K1 and K4) and of the FMA route;
# every bf16 one takes the wgmma route
TF32X3_HEAD_DIMS = (64,)
FMA_HEAD_DIMS = (128, 192, 256, 320, 384, 448, 512)
# bf16 head dims of the wgmma route's wide kernel (csrc/
# flash_attention_wide.cu: O split across two consumer warpgroups)
WIDE_HEAD_DIMS = (320, 384, 448, 512)
# the FMA route's tiles (BR and BC in csrc/flash_attention_f32.cu) and the
# wide kernel's (WideCfg): query rows a block, keys a kv tile
FMA_BLOCK_Q, FMA_BLOCK_K = 64, 256
WIDE_BLOCK_Q, WIDE_BLOCK_K = 64, 64
# K4 takes what K1 takes: d = 64 (every SDXL UNet head) on its own
# kernels, 128-512 (the VAE's d = 512) on the sliced ones
BWD_HEAD_DIMS = HEAD_DIMS
# K4's kernels at d = 128-512 (`bwd_plan`): bf16 splits D across the
# blocks of a cluster (128 own rows a block, two consumer warpgroups, at
# most two 64-wide panels of D a block, 64 streamed rows a tile in both
# kernels; S and dP summed across the cluster through distributed shared
# memory)
SLICED_ROWS = 128
SLICE_PANELS = 2
SLICED_STREAM = {"dkv": 64, "dq": 64}
SLICED_MAX_STAGES = 4
# fp32 splits D the same way (128 columns a block) with 64 own rows a
# block (consumer warpgroup 0 forms S, 1 dP), 32 streamed rows a tile
# through two TMA stages, each streamed tile's lo part copied into one
# buffer, 6 exchange slots a warpgroup (a float4 a thread each)
TF32_SLICED_ROWS = 64
TF32_SLICED_STREAM = 32
TF32_SLICED_STAGES = 2
TF32_SLICED_SLOTS = 6
# the block of a cluster of 1-4 blocks that owns each quarter of a
# streamed tile (bf16: a 16-row k step of 64; fp32: an 8-row n tile of 32)
TILE_OWNERS = ((0, 0, 0, 0), (0, 0, 1, 1), (0, 0, 1, 2), (0, 1, 2, 3))
# the shared memory a block may take on an H100
SMEM_PER_BLOCK = 232448


def flash_attention_plain(q, k, v, scale: float):
    """q: (B, Sq, H, D); k, v: (B, Sk, H, D) -> (out (B, Sq, H*D) in q's
    dtype, lse (B, H, Sq) f32, natural log): f32 softmax over explicit
    matmuls."""
    b, sq, h, d = q.shape
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.exp(logits - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype).reshape(b, sq, h * d), lse


def route(dtype, head_dim: int) -> str:
    """The K1 kernel a CUDA call of this dtype and head dim launches:
    "wgmma" (every bf16 head dim: csrc/flash_attention_sm90.cu at d <=
    256, csrc/flash_attention_wide.cu at d >= 320), "tf32x3"
    (csrc/flash_attention_tf32.cu: fp32 d = 64, 3xTF32 on the tensor
    cores) or "fma" (csrc/flash_attention_f32.cu: every other fp32 head
    dim, exact fp32 on the FMA pipes). Raises on what K1 does not take."""
    if dtype not in _DTYPES:
        raise TypeError(f"flash attention takes float32 or bfloat16, got "
                        f"{dtype}")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"flash attention head_dim {head_dim} not in "
                         f"{HEAD_DIMS}")
    if dtype == torch.bfloat16:
        return "wgmma"
    if head_dim in TF32X3_HEAD_DIMS:
        return "tf32x3"
    return "fma"


def fma_tiles(head_dim: int) -> dict:
    """The FMA route's per-head-dim choices (csrc/flash_attention_f32.cu's
    FmaCfg makes the same and static_asserts their bounds): kv rows of a
    V chunk (`v_rows`: the most, a power of two dividing the 256-key tile,
    whose d columns fit the 16 KB of a K chunk of 256 keys x 16 d), the
    columns of a V box (`v_box`: d up to 256 in one TMA box, two halves
    above, at most 256 a box), the O columns a thread updates from one
    shared-memory load (`vector`: a float4 where each column quarter of d
    holds 8 lanes' float4s evenly, d % 128 == 0, else a float2) and the O
    columns a thread holds (`o_cols`: d / 32, 8 rows each)."""
    if head_dim not in FMA_HEAD_DIMS:
        raise ValueError(f"the FMA route takes head_dim in "
                         f"{FMA_HEAD_DIMS}, got {head_dim}")
    stage = FMA_BLOCK_K * 16
    v_rows = 32
    while v_rows * head_dim > stage:
        v_rows //= 2
    return {"v_rows": v_rows,
            "v_box": head_dim if head_dim <= 256 else head_dim // 2,
            "vector": 4 if head_dim % 128 == 0 else 2,
            "o_cols": head_dim // 32}


def wide_o_split(head_dim: int) -> tuple:
    """The columns of O that the wide kernel's two consumer warpgroups
    own at a bf16 head dim of WIDE_HEAD_DIMS: (D0, D - D0), D0 = 64 *
    ceil(D / 128), each part a multiple of 64 (one 128-byte-swizzled V
    panel, where a wgmma's N must start) and at most 256 (the widest
    wgmma, 128 f32 registers a thread). csrc/flash_attention_wide.cu's
    WideCfg makes the same split and static_asserts these bounds."""
    if head_dim not in WIDE_HEAD_DIMS:
        raise ValueError(f"the wide kernel takes head_dim in "
                         f"{WIDE_HEAD_DIMS}, got {head_dim}")
    d0 = 64 * -(-head_dim // 128)
    return d0, head_dim - d0


def bwd_route(dtype, head_dim: int) -> str:
    """The K4 kernels a CUDA backward of this dtype and head dim launches:
    "wgmma" (bf16 d = 64: wgmma + TMA, warp-specialised, in
    csrc/flash_attention_bwd.cu), "tf32x3" (fp32 d = 64: mma.sync at
    3xTF32, in csrc/flash_attention_tf32.cu beside K1's fp32 d = 64
    forward), "wgmma_sliced" (bf16 d = 128-512: wgmma + TMA, each block of
    a cluster a slice of D, in csrc/flash_attention_bwd_sliced.cu) or
    "tf32x3_sliced" (fp32 d = 128-512: each block of a cluster a slice of
    D, every product on TF32 wgmma at 3xTF32, in
    csrc/flash_attention_bwd_sliced_tf32.cu).
    Raises on what K4 does not take."""
    if dtype not in _DTYPES:
        raise TypeError(f"flash attention backward takes float32 or "
                        f"bfloat16, got {dtype}")
    if head_dim not in BWD_HEAD_DIMS:
        raise ValueError(f"flash attention backward: head_dim {head_dim} "
                         f"not in {BWD_HEAD_DIMS}")
    route = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
    return route if head_dim == 64 else route + "_sliced"


def exchange_slots(cluster: int) -> dict:
    """Where each block of an fp32 cluster of `cluster` blocks receives
    what it sums (csrc/flash_attention_bwd_sliced_tf32.cu's fs_r1_slot and
    fs_r2_slot static_assert the same): {receiver: {("share", sender, n
    tile): slot, ("sum", n tile): slot}}. Round 1 brings the receiver
    every other block's share of each n tile it owns (TILE_OWNERS), the
    senders in rank order; round 2, in the slots after those, the sum of
    each n tile it does not own, from that tile's owner."""
    owners = TILE_OWNERS[cluster - 1]
    out = {}
    for r in range(cluster):
        mine = [j for j in range(4) if owners[j] == r]
        slots = {("share", s, j): (s if s < r else s - 1) * len(mine) + i
                 for s in range(cluster) if s != r
                 for i, j in enumerate(mine)}
        rest = [j for j in range(4) if owners[j] != r]
        slots.update({("sum", j): (cluster - 1) * len(mine) + i
                      for i, j in enumerate(rest)})
        out[r] = slots
    return out


def _tf32_sliced_plan(route: str, head_dim: int) -> dict:
    """The fp32 kernels' plan (see `bwd_plan`)."""
    slices = tuple((c, min(128, head_dim - c))
                   for c in range(0, head_dim, 128))
    cluster = len(slices)
    # 1 KB of alignment, a 1 KB head (barriers; the dk/dv kernel's lse and
    # delta rows), the own rows of both own tensors (128 columns), two
    # stages of both streamed tensors as landed, one buffer of their lo
    # copies, P^T / dS^T (dS for dq) hi and lo for each warpgroup (own rows
    # by streamed rows), the two warpgroups' exchange slots and the P
    # hand-off (four n tiles)
    own = 2 * TF32_SLICED_ROWS * 128 * 4
    stage = 2 * TF32_SLICED_STREAM * 128 * 4
    pb = 2 * 2 * TF32_SLICED_ROWS * TF32_SLICED_STREAM * 4
    slot = 128 * 16
    smem = (1024 + 1024 + own + TF32_SLICED_STAGES * stage + stage + pb
            + 2 * TF32_SLICED_SLOTS * slot + 4 * slot)
    return {"route": route, "split": "cluster", "rows": TF32_SLICED_ROWS,
            "cluster": cluster, "owners": TILE_OWNERS[cluster - 1],
            "slices": {"dkv": slices, "dq": slices},
            "stream": {"dkv": TF32_SLICED_STREAM, "dq": TF32_SLICED_STREAM},
            "stages": {"dkv": TF32_SLICED_STAGES, "dq": TF32_SLICED_STAGES},
            "flops": 14, "wgmma": ("S", "dP", "dV", "dK", "dQ"),
            "copies": ("lo",), "transposed": ("dV", "dK", "dQ"),
            "slots": TF32_SLICED_SLOTS,
            "smem": {"dkv": smem, "dq": smem}}


def bwd_plan(dtype, head_dim: int) -> dict:
    """K4's kernels at a head dim of 128-512, as
    csrc/flash_attention_bwd_sliced.cu (bf16) and
    csrc/flash_attention_bwd_sliced_tf32.cu (fp32) make them and
    static_assert them. Each of the dk/dv and the dq kernel owns `rows`
    rows a block (keys, or q rows) and streams the other side in tiles of
    `stream` rows (by kernel) through `stages` stages; `slices` (by
    kernel, as (first column, width)) split the output's columns across
    the blocks of a thread-block cluster of `cluster` blocks along the
    grid (`split`), 128 wide (the last 64 where D / 64 is odd); the blocks
    share their own rows, each forms its share of S and dP over its
    columns, and the cluster sums the shares through distributed shared
    memory (block `owners[j]` sums quarter j of a streamed tile), so
    nothing is recomputed (14 flops).
    - bf16: 128 own rows, 64 streamed rows a tile, as many ring stages as
      fit beside the own rows and the exchange buffers (at most 4); the
      owner forms P and dS and sends them back.
    - fp32: 64 own rows, S on one consumer warpgroup and dP on the other,
      32 streamed rows a tile through two stages, every product on TF32
      wgmma at 3xTF32 (`wgmma`); each streamed tile's lo part is written
      once into one buffer (`copies`; the tile as landed is hi), and dV,
      dK and dQ run `transposed` (dV^T = dO^T P, ...: the streamed tile as
      register A, P^T, dS^T or dS written hi and lo as B); the owner sends
      the sums back (`exchange_slots`), and `smem` bytes a block."""
    route = bwd_route(dtype, head_dim)
    if head_dim == 64:
        raise ValueError("K4's sliced kernels take head_dim 128-512; "
                         "d = 64 has kernels of its own")
    if route == "tf32x3_sliced":
        return _tf32_sliced_plan(route, head_dim)
    panels = head_dim // 64
    slices = tuple((64 * p, 64 * min(SLICE_PANELS, panels - p))
                   for p in range(0, panels, SLICE_PANELS))
    cluster = len(slices)
    # a block: both own tensors' slice panels, the stages (both streamed
    # tensors' slice panels, 32 KB), with a cluster each consumer
    # warpgroup's receive buffers (round 1: from each other block the
    # shares of the k steps this block owns, 2 KB an n tile of S or dP;
    # round 2: the fragments of P (dk/dv) and dS of every k step, 2 KB
    # each); 1024 bytes of alignment, then a head of barriers and (dk/dv)
    # each stage's lse and delta rows, to a kilobyte
    owners = TILE_OWNERS[cluster - 1]
    most = max(owners.count(r) for r in range(cluster))
    own = 2 * SLICE_PANELS * SLICED_ROWS * 128
    stages = {}
    for kern, rows in SLICED_STREAM.items():
        stage = 2 * SLICE_PANELS * rows * 128
        exchange = 0 if cluster == 1 else 2 * (
            (cluster - 1) * most * 4 * 2048
            + 4 * (1 if kern == "dq" else 2) * 2048)
        n = SLICED_MAX_STAGES
        while n > 1:
            head = -(-(128 + (0 if kern == "dq" else n * 2 * rows * 4))
                     // 1024) * 1024
            if 1024 + head + own + n * stage + exchange <= SMEM_PER_BLOCK:
                break
            n -= 1
        stages[kern] = n
    return {"route": route, "split": "cluster", "rows": SLICED_ROWS,
            "cluster": cluster, "owners": owners,
            "slices": {"dkv": slices, "dq": slices},
            "stream": dict(SLICED_STREAM), "stages": stages, "flops": 14}


def kv_splits(blocks: int, kv_tiles: int, sms: int) -> int:
    """Into how many parts the FMA route and the wide wgmma kernel split
    each kv walk, for a grid of `blocks` (query block, head, batch) blocks
    over `kv_tiles` kv tiles on a card of `sms` SMs (one block each): the
    count whose grid fills its last wave best, the smallest on a tie, at
    most 16 and one tile a split, so that each split owns at least one
    tile. One where the grid already fills the card's waves (S = 16384 at
    one head: 256 blocks), two at S = 4096 (64 -> 128 blocks)."""
    best, best_fill = 1, 0.0
    for n in range(1, min(16, kv_tiles) + 1):
        per = -(-kv_tiles // n)
        n = -(-kv_tiles // per)  # splits that own a tile
        grid = blocks * n
        fill = grid / (-(-grid // sms) * sms)
        if fill > best_fill + 1e-9:
            best, best_fill = n, fill
    return best


# layouts `_check` has accepted, by the dtypes, devices, shapes, strides
# and pointer alignment of q, k and v: (K1's route, its kv splits, the
# packed layout part of its call, whether it takes the wide kernel)
_ACCEPTED = {}


def _check(q, k, v):
    """Raises on (B, S, H, D) views that K1 and K4 do not take; returns
    (route, kv splits, packed layout, wide kernel or not) for K1's call. A layout accepted
    once is found again after one dict lookup."""
    key = (q.dtype, k.dtype, v.dtype,
           q.get_device(), k.get_device(), v.get_device(),
           q.shape, k.shape, v.shape, q.stride(), k.stride(), v.stride(),
           (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16)
    entry = _ACCEPTED.get(key)
    if entry is None:
        _check_layout(q, k, v)
        entry = _fwd_layout(q, k, v)
        if len(_ACCEPTED) >= 4096:
            _ACCEPTED.clear()
        _ACCEPTED[key] = entry
    return entry


def _fwd_layout(q, k, v):
    """K1's route, kv splits, packed layout and whether it takes the wide
    kernel, for a checked (q, k, v)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    kernel = route(q.dtype, d)
    wide = kernel == "wgmma" and d in WIDE_HEAD_DIMS
    splits = 1
    if kernel == "fma" or wide:
        bq, bk = ((FMA_BLOCK_Q, FMA_BLOCK_K) if kernel == "fma"
                  else (WIDE_BLOCK_Q, WIDE_BLOCK_K))
        splits = kv_splits(
            b * h * -(-sq // bq), -(-sk // bk),
            torch.cuda.get_device_properties(q.device).multi_processor_count)
    return kernel, splits, _FWD_LAYOUT.pack(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], q.get_device(),
        _DTYPES[q.dtype], d, b, sq, sk, h, splits), wide


def _check_layout(q, k, v):
    """Raises on (B, S, H, D) views that K1 and K4 do not take."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash attention: q, k, v must all be on CUDA")
    if not (q.device == k.device == v.device):
        raise ValueError("flash attention: q, k, v on different devices")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash attention takes float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes (B, S, H, D) views")
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"flash attention shapes differ: {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash attention head_dim {d} not in {HEAD_DIMS}")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash attention: {name} needs unit stride "
                             f"along D")
        if any(s % vec for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"flash attention: {name} strides/pointer not "
                             f"16-byte aligned")
    if min(sq, k.shape[1]) < 1:
        raise ValueError("flash attention: empty sequence")
    if max(sq, k.shape[1]) >= 2 ** 31 or b > 65535 or h * 16 > 65535:
        raise ValueError("flash attention: shape beyond the launch grid")


def flash_attention_fwd(q, k, v, *, scale=None):
    """q: (B, Sq, H, D); k, v: (B, Sk, H, D), any strides with unit D
    stride. Returns (out (B, Sq, H*D), lse (B, H, Sq) f32)."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, scale)
    kernel, splits, layout, wide = _check(q, k, v)
    b, sq, h, _ = q.shape
    out = q.new_empty((b, sq, h * d))
    lse = q.new_empty((b, h, sq), dtype=torch.float32)
    part = None
    if splits > 1:
        # each split's normalised output, then its lse, in f32
        part = torch.empty(splits * b * h * sq * (d + 1),
                           dtype=torch.float32, device=q.device)
    err = cuda_build.library().vst_flash_attention_fwd(
        _FWD_POINTERS.pack(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           out.data_ptr(), lse.data_ptr(),
                           0 if part is None else part.data_ptr(),
                           cuda_build.stream_of(q))
        + layout + _FWD_SCALE.pack(scale))
    cuda_build.check_launch("flash_attention_fwd", err)
    global LAUNCHES, WIDE_LAUNCHES
    LAUNCHES += 1
    ROUTE_LAUNCHES[kernel] += 1
    WIDE_LAUNCHES += wide
    return out, lse


def flash_attention_bwd_delta_plain(o, do, num_heads: int):
    """delta = rowsum(dO * O) in f32: o, do (B, Sq, H*D) -> (B, H, Sq)."""
    b, sq, hd = o.shape
    prod = (do.reshape(b, sq, num_heads, hd // num_heads).float()
            * o.reshape(b, sq, num_heads, hd // num_heads).float())
    return prod.sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_delta(o, do, num_heads: int):
    """K4's delta = rowsum(dO * O): o, do (B, Sq, H*D) contiguous in one
    dtype -> (B, H, Sq) f32, one kernel on the card (the plain version for
    CPU tensors)."""
    if not o.is_cuda:
        return flash_attention_bwd_delta_plain(o, do, num_heads)
    b, sq, hd = o.shape
    d = hd // num_heads
    if do.shape != o.shape or do.dtype != o.dtype or not do.is_cuda:
        raise ValueError(f"flash attention delta: do {tuple(do.shape)} "
                         f"{do.dtype}, expected {tuple(o.shape)} {o.dtype}")
    bwd_route(o.dtype, d)
    for name, t in (("o", o), ("do", do)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash attention delta: {name} must be "
                             f"contiguous and 16-byte aligned")
    delta = torch.empty((b, num_heads, sq), dtype=torch.float32,
                        device=o.device)
    lib = cuda_build.library()
    with torch.cuda.device(o.device):
        err = lib.vst_flash_attention_bwd_delta(
            _DTYPES[o.dtype], d, o.data_ptr(), do.data_ptr(),
            delta.data_ptr(), b, sq, num_heads, cuda_build.stream_of(o))
    cuda_build.check_launch("flash_attention_bwd_delta", err)
    global DELTA_LAUNCHES
    DELTA_LAUNCHES += 1
    return delta


def flash_attention_bwd_plain(q, k, v, o, lse, do, scale: float):
    """The backward from the saved lse (the JAX `_recompute_p_ds` math):
    p = exp(q k^T * scale - lse), dp = dO v^T, delta = rowsum(dO * O),
    ds = p (dp - delta) scale; dq = ds k, dk = ds^T q, dv = p^T dO, all in
    f32, with p and ds rounded to the input dtype before their products
    as the JAX kernels round them. q: (B, Sq, H, D); k, v: (B, Sk, H, D);
    o, do: (B, Sq, H*D); lse (B, H, Sq) f32. Returns dq, dk, dv shaped
    like q, k, v in q's dtype."""
    b, sq, h, d = q.shape
    dt = q.dtype
    qf, kf, vf = q.float(), k.float(), v.float()
    dof = do.reshape(b, sq, h, d).float()
    delta = flash_attention_bwd_delta_plain(o, do, h)                # (B,H,Sq)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None]) * scale
    p = p.to(dt).float()
    ds = ds.to(dt).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _check_bwd(q, k, v, o, lse, do):
    """Raises on what K4 does not take; returns its route."""
    _check(q, k, v)
    b, sq, h, d = q.shape
    kernel = bwd_route(q.dtype, d)
    for name, t, shape, dtype in (("o", o, (b, sq, h * d), q.dtype),
                                  ("do", do, (b, sq, h * d), q.dtype),
                                  ("lse", lse, (b, h, sq), torch.float32)):
        if tuple(t.shape) != shape or t.dtype != dtype or not t.is_cuda:
            raise ValueError(f"flash attention backward: {name} "
                             f"{tuple(t.shape)} {t.dtype}, expected "
                             f"{shape} {dtype} on CUDA")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash attention backward: {name} must be "
                             f"contiguous and 16-byte aligned")
    return kernel


def flash_attention_bwd(q, k, v, o, lse, do, *, scale=None):
    """Gradients of `flash_attention_fwd`: (dq, dk, dv), each (B, S, H, D)
    contiguous in q's dtype. delta = rowsum(dO * O) is a kernel of its own
    (XLA in the JAX package); the kernels recompute p from the saved
    lse."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if not q.is_cuda:
        return flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
    do = do.contiguous()
    kernel = _check_bwd(q, k, v, o, lse, do)
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    delta = flash_attention_bwd_delta(o, do, h)                   # (B,H,Sq)
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, h, d), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, sk, h, d), dtype=q.dtype, device=q.device)
    lib = cuda_build.library()
    with torch.cuda.device(q.device):
        err = lib.vst_flash_attention_bwd(
            _DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, sq, sk, h,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(scale), cuda_build.stream_of(q))
    cuda_build.check_launch("flash_attention_bwd", err)
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1
    BWD_ROUTE_LAUNCHES[kernel] += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """K1 forward, K4 backward; the residuals are the JAX ones (q, k, v,
    out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_attention_fwd(q, k, v, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, grad,
                                         scale=ctx.scale)
        return dq, dk, dv, None


def flash_attention_bshd(q, k, v, *, scale=None):
    """q, k, v: (B, S, H, D) -> (B, Sq, H*D), differentiable (K4)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q, k, v, float(scale))


def _route_name(x, head_dim: int) -> str:
    """The route a call on x launches, for its span."""
    return route(x.dtype, head_dim) if x.is_cuda else "plain"


def flash_attention(q, k, v, *, scale=None):
    """q, k, v: (B, S, H, D) -> (B, S, H, D) (the JAX `flash_attention`
    signature)."""
    with tracing.op_span("K1", _route_name, q, q.shape[-1]):
        b, sq, h, d = q.shape
        return flash_attention_bshd(q, k, v, scale=scale).reshape(
            b, sq, h, d)


def flash_attention_qkv(qkv, num_heads: int, *, scale=None):
    """Self-attention over a fused projection: qkv (B, S, 3*H*D) ->
    (B, S, H*D). The q, k and v segments are strided views of qkv; the
    kernel reads them in place."""
    with tracing.op_span("K1", _route_name, qkv,
                         qkv.shape[-1] // 3 // num_heads):
        b, s, hd3 = qkv.shape
        hd = hd3 // 3
        d = hd // num_heads
        q = qkv[..., :hd].unflatten(-1, (num_heads, d))
        k = qkv[..., hd:2 * hd].unflatten(-1, (num_heads, d))
        v = qkv[..., 2 * hd:].unflatten(-1, (num_heads, d))
        return flash_attention_bshd(q, k, v, scale=scale)
