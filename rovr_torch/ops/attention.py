"""K2-K4: flash attention, forward (K2), dq (K3) and dk/dv (K4).

Replaces `rovr_tpu/ops/pallas/attention.py`: `_fwd_kernel` (through
`_flash_forward`), `_dq_kernel` and `_dkv_kernel` (through
`_flash_backward`), and the public `flash_attention` with its custom_vjp.
out = softmax(q k^T d^-1/2) v over (B,H,Lq,D) queries and (B,H,Lk,D)
keys/values, self or cross (Lq != Lk), any L and D up to 256, the JAX
layout at the public function.

What bounds them on an H100: at the PPO shape of config 5 (512 sequences x
4 heads x 256 tokens x D 64) K2 does 34.4 GFLOP on 270.5 MB, 127 operations
per byte, and K3/K4 52-69 GFLOP on 340-407 MB, all under the card's ~295:
device memory bounds them. None of them pads D to 128 lanes or broadcasts
LSE over 128 lanes as the TPU kernels did.

K2 (csrc/flash_attention.cu, `flash_fwd_tma_kernel`) takes every D % 8 == 0
up to 128: persistent blocks walk (head, query tile) items; one producer
thread keeps TMA loads of Q and of the head's K/V tiles in flight (ragged L
and D zero-filled by TMA), so the next item's loads overlap this item's
products; one or two consumer warpgroups run S = Q K^T and O += P V as
`wgmma` (P from registers) with the online softmax in f32 registers; O
leaves by a TMA store.

K3 (`flash_dq_tma_kernel`, replacing `_dq_kernel`) and K4
(`flash_dkv_tma_kernel`, replacing `_dkv_kernel`) take the same D and the
same plan, bound by bytes as K2 is (52-69 GFLOP on 340-407 MB at the PPO
shape, `attention_cost` in h100bench/work.py): persistent blocks over (head,
query tile) items for K3 and (head, key tile) items for K4; each item's Q
and dO (K3) or K and V (K4) arrive once by TMA, and one producer thread
streams the head's K and V (K3) or Q, dO, LSE and delta (K4) through an
mbarrier ring; every product is a `wgmma` (S and dP from shared memory, dQ
+= dS K, dV += P^T dO and dK += dS^T Q with P and dS as bf16 from registers
and the second operand read MN-major, so nothing is transposed by a copy);
the outputs leave by TMA stores, each written once.

The `mma.sync` kernels of the first port (`flash_fwd_kernel`,
`flash_dq_kernel`, `flash_dkv_kernel`) stay for D % 8 != 0 (TMA needs
16-byte row strides) and D > 128 (the TMA kernels' buffers do not fit in
shared memory); `flash_fwd_route` (and `flash_bwd_route`, the same rule)
states it, and the C entry points apply it to each launch.

Each kernel has a plain PyTorch twin here, mirroring its arithmetic in f32
with the kernel's bf16 rounding points (P and dS rounded to the input
dtype before their second product): `flash_attention_fwd_plain`,
`flash_attention_dq_plain`, `flash_attention_dkv_plain`. The wrappers
`flash_attention_fwd`, `flash_attention_dq` and `flash_attention_dkv`
launch the kernel for CUDA tensors (bf16 q/k/v/dO, f32 lse/delta; anything
else raises, as does any build, encode or launch error) and add one to their
own `launches` count; a CPU tensor runs the twin. There is no fallback.
`flash_attention_fwd_mma`, `flash_attention_dq_mma` and
`flash_attention_dkv_mma` launch the mma.sync kernels whatever D: test hooks
for holding the two routes against each other, which the port never calls.

`flash_attention(q, k, v)` is the differentiable op: an autograd.Function
whose forward is K2 and whose backward computes delta = rowsum(dO * O) in
f32 as a plain op (as the JAX package does outside its kernels), then K3
and K4.
"""

from __future__ import annotations

import ctypes

import torch

from rovr_torch.ops import cuda_build

_SOURCE = "flash_attention"
MAX_HEAD_DIM = 256
TMA_MAX_HEAD_DIM = 128


def flash_fwd_route(d: int) -> str:
    """Which kernel K2 (and K3 and K4: `flash_bwd_route`) launches for head
    dim d: "tma" (TMA + wgmma) for d % 8 == 0 up to TMA_MAX_HEAD_DIM, else
    "mma" (the mma.sync kernel). The C entry points apply the same rule
    (rovr_flash_fwd_route, rovr_flash_bwd_route)."""
    return "tma" if d % 8 == 0 and d <= TMA_MAX_HEAD_DIM else "mma"


flash_bwd_route = flash_fwd_route  # one rule for both directions


def _scores(q, k):
    """f32 q k^T d^-1/2, (B,H,Lq,Lk)."""
    return (q.float() @ k.float().transpose(-1, -2)) * (q.shape[-1] ** -0.5)


def flash_attention_fwd_plain(q, k, v):
    """K2's plain twin: (out in q's dtype, lse (B,H,Lq) f32)."""
    s = _scores(q, k)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None]).to(q.dtype).float()
    return (p @ v.float()).to(q.dtype), lse


def flash_attention_dq_plain(q, k, v, do, lse, delta):
    """K3's plain twin: dq = d^-1/2 (P (dO v^T - delta)) k."""
    p = torch.exp(_scores(q, k) - lse[..., None].float())
    ds = p * (do.float() @ v.float().transpose(-1, -2) - delta[..., None].float())
    dq = (ds.to(q.dtype).float() @ k.float()) * (q.shape[-1] ** -0.5)
    return dq.to(q.dtype)


def flash_attention_dkv_plain(q, k, v, do, lse, delta):
    """K4's plain twin: (dk, dv) = (d^-1/2 dS^T q, P^T dO)."""
    p = torch.exp(_scores(q, k) - lse[..., None].float())
    ds = p * (do.float() @ v.float().transpose(-1, -2) - delta[..., None].float())
    dv = p.to(q.dtype).float().transpose(-1, -2) @ do.float()
    dk = (ds.to(q.dtype).float().transpose(-1, -2) @ q.float()) * (q.shape[-1] ** -0.5)
    return dk.to(k.dtype), dv.to(v.dtype)


def check_kernel_args(q, k, v, do=None, lse=None, delta=None) -> None:
    """Raise on anything the CUDA kernels do not take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(
            f"flash_attention: q, k, v are (B,H,L,D); got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if tuple(k.shape) != (b, h, lk, d) or tuple(v.shape) != (b, h, lk, d):
        raise ValueError(
            f"flash_attention: k {tuple(k.shape)} / v {tuple(v.shape)} do not "
            f"fit q {tuple(q.shape)}"
        )
    if min(b * h, lq, lk, d) < 1 or d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernels need 1 <= D <= {MAX_HEAD_DIM} "
                         f"and non-empty B*H, L; got {tuple(q.shape)}, Lk {lk}")
    if b * h * max(lq, lk) * d >= 2 ** 31:
        raise ValueError("flash_attention kernels need B*H*L*D < 2^31")
    tensors = {"q": q, "k": k, "v": v}
    if do is not None:
        if tuple(do.shape) != tuple(q.shape):
            raise ValueError(f"flash_attention: dO {tuple(do.shape)} != q {tuple(q.shape)}")
        for name, t in (("lse", lse), ("delta", delta)):
            if tuple(t.shape) != (b, h, lq):
                raise ValueError(f"flash_attention: {name} {tuple(t.shape)} != {(b, h, lq)}")
            if t.dtype != torch.float32:
                raise TypeError(f"flash_attention kernels take an f32 {name}, got {t.dtype}")
        tensors.update(do=do, lse=lse, delta=delta)
    for name in ("q", "k", "v", "do"):
        if name in tensors and tensors[name].dtype != torch.bfloat16:
            raise TypeError(
                f"flash_attention kernels take bf16 {name}, got {tensors[name].dtype}")
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention kernels need a contiguous {name}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention kernels need a 16-byte aligned {name}")


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(_SOURCE)
    if lib.rovr_flash_fwd_bf16.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rovr_flash_fwd_bf16.argtypes = [p] * 5 + [i] * 4 + [p]
        lib.rovr_flash_fwd_mma_bf16.argtypes = [p] * 5 + [i] * 4 + [p]
        for name in ("rovr_flash_dq_bf16", "rovr_flash_dq_mma_bf16"):
            getattr(lib, name).argtypes = [p] * 7 + [i] * 4 + [p]
        for name in ("rovr_flash_dkv_bf16", "rovr_flash_dkv_mma_bf16"):
            getattr(lib, name).argtypes = [p] * 8 + [i] * 4 + [p]
        lib.rovr_flash_fwd_route.argtypes = [i]
        lib.rovr_flash_bwd_route.argtypes = [i]
        lib.rovr_flash_tma_smem.argtypes = [i] * 3
        for fn in (lib.rovr_flash_fwd_bf16, lib.rovr_flash_fwd_mma_bf16,
                   lib.rovr_flash_dq_bf16, lib.rovr_flash_dq_mma_bf16,
                   lib.rovr_flash_dkv_bf16, lib.rovr_flash_dkv_mma_bf16,
                   lib.rovr_flash_fwd_route, lib.rovr_flash_bwd_route,
                   lib.rovr_flash_tma_smem):
            fn.restype = ctypes.c_int
        lib.rovr_flash_error_string.argtypes = [ctypes.c_int]
        lib.rovr_flash_error_string.restype = ctypes.c_char_p
    return lib


def _call(name: str, q, k, *ptrs) -> None:
    lib = _lib()
    b, h, lq, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, name)(*ptrs, b * h, lq, k.shape[2], d, stream)
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.rovr_flash_error_string(err).decode())


def _on_cuda(name: str, t) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, got {t.device}")
    return True


def _fwd(name: str, q, k, v):
    check_kernel_args(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _call(name, q, k, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
          lse.data_ptr())
    return o, lse


def flash_attention_fwd(q, k, v):
    """K2: (out (B,H,Lq,D) in q's dtype, lse (B,H,Lq) f32). A CUDA q
    launches the kernel `flash_fwd_route` names and adds one to
    `flash_attention_fwd.launches`; a CPU q runs the plain twin."""
    if not _on_cuda("flash_attention_fwd", q):
        return flash_attention_fwd_plain(q, k, v)
    out = _fwd("rovr_flash_fwd_bf16", q, k, v)
    flash_attention_fwd.launches += 1
    return out


def flash_attention_fwd_mma(q, k, v):
    """Test hook: K2 by the mma.sync kernel whatever D (CUDA tensors
    only), to hold the two forwards against each other on the same inputs.
    The port never calls it, and it counts no K2 launch."""
    if not _on_cuda("flash_attention_fwd_mma", q):
        raise ValueError("flash_attention_fwd_mma launches a CUDA kernel; q is on the CPU")
    return _fwd("rovr_flash_fwd_mma_bf16", q, k, v)


def _dq(name: str, q, k, v, do, lse, delta):
    check_kernel_args(q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    _call(name, q, k, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
          lse.data_ptr(), delta.data_ptr(), dq.data_ptr())
    return dq


def _dkv(name: str, q, k, v, do, lse, delta):
    check_kernel_args(q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _call(name, q, k, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
          lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr())
    return dk, dv


def flash_attention_dq(q, k, v, do, lse, delta):
    """K3: dq (B,H,Lq,D). A CUDA q launches the kernel `flash_bwd_route`
    names and adds one to `flash_attention_dq.launches`; a CPU q runs the
    plain twin."""
    if not _on_cuda("flash_attention_dq", q):
        return flash_attention_dq_plain(q, k, v, do, lse, delta)
    dq = _dq("rovr_flash_dq_bf16", q, k, v, do, lse, delta)
    flash_attention_dq.launches += 1
    return dq


def flash_attention_dq_mma(q, k, v, do, lse, delta):
    """Test hook: K3 by the mma.sync kernel whatever D (CUDA tensors only).
    The port never calls it, and it counts no K3 launch."""
    if not _on_cuda("flash_attention_dq_mma", q):
        raise ValueError("flash_attention_dq_mma launches a CUDA kernel; q is on the CPU")
    return _dq("rovr_flash_dq_mma_bf16", q, k, v, do, lse, delta)


def flash_attention_dkv(q, k, v, do, lse, delta):
    """K4: (dk, dv), each (B,H,Lk,D). A CUDA q launches the kernel
    `flash_bwd_route` names and adds one to `flash_attention_dkv.launches`;
    a CPU q runs the plain twin."""
    if not _on_cuda("flash_attention_dkv", q):
        return flash_attention_dkv_plain(q, k, v, do, lse, delta)
    out = _dkv("rovr_flash_dkv_bf16", q, k, v, do, lse, delta)
    flash_attention_dkv.launches += 1
    return out


def flash_attention_dkv_mma(q, k, v, do, lse, delta):
    """Test hook: K4 by the mma.sync kernel whatever D (CUDA tensors only).
    The port never calls it, and it counts no K4 launch."""
    if not _on_cuda("flash_attention_dkv_mma", q):
        raise ValueError("flash_attention_dkv_mma launches a CUDA kernel; q is on the CPU")
    return _dkv("rovr_flash_dkv_mma_bf16", q, k, v, do, lse, delta)


for _fn in (flash_attention_fwd, flash_attention_dq, flash_attention_dkv):
    _fn.launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_attention_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        g = g.to(q.dtype).contiguous()
        delta = (g.float() * o.float()).sum(-1)
        dq = flash_attention_dq(q, k, v, g, lse, delta)
        dk, dv = flash_attention_dkv(q, k, v, g, lse, delta)
        return dq, dk, dv


def flash_attention(q, k, v):
    """softmax(q k^T / sqrt(D)) v, (B,H,Lq,D) x (B,H,Lk,D) -> (B,H,Lq,D),
    differentiable. CUDA tensors run K2 forward and K3/K4 backward; CPU
    tensors their plain twins."""
    return _FlashAttention.apply(q, k, v)

