"""WKV6 recurrence, the time-mix hot spot of RWKV-6 — counterpart of the
JAX package's ``kernels/rwkv6_kernel.py``, whose Pallas TPU kernel
``rwkv6_chunked`` is here a hand-written CUDA C++ kernel for Hopper
(``csrc/rwkv6.cu``, built by ``kernels.build``).

Per (b, h), with S[i, j] indexed [key channel i, value channel j], in
float32:

    y_t = r_t · S + (r_t · (u ⊙ k_t)) v_t
    S  <- diag(w_t) · S + k_tᵀ v_t

``rwkv6_chunked`` launches the kernel for CUDA tensors and counts the launch in
its ``.launches``; it runs ``rwkv6_chunked_plain`` — the same recurrence as a
step-by-step float32 loop in plain PyTorch — only for tensors on the CPU.
There is no fallback: a CUDA tensor the kernel does not take raises, and so
does an input autograd would record (the kernel has no backward:
``kernels.refuse_autograd``).  The kernel runs a sequence of ``CHUNK`` or more
steps in the chunked, parallel-in-time form that ``rwkv6_chunkwise_plain``
spells out in plain PyTorch (the CPU tests hold that form against the
step-by-step one); shorter ones (decode) step by step.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, refuse_autograd

SUPPORTED_DH = (16, 32, 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's chunk (kChunk in csrc/rwkv6.cu): sequences of CHUNK or more
# steps run the chunked body, shorter ones the per-step body
CHUNK = 16
# the chunked form's floor of log2 w (kLog2Floor): w = 0 decays by 2^-40
LOG2_FLOOR = -40.0


def _new_y(B, H, S, dh, device):
    """A (B, H, S, dh) float32 output over (B, S, H, dh) memory: the
    model's layout, so the caller's transpose back is free."""
    return torch.empty((B, S, H, dh), dtype=torch.float32,
                       device=device).transpose(1, 2)


def rwkv6_chunked_plain(r, k, v, w, u, state, *, out_state=None):
    """Plain PyTorch version of :func:`rwkv6_chunked`: one float32 step per
    time step.  Same arguments and result."""
    B, H, S, dh = r.shape
    r, k, v, w = (t.float() for t in (r, k, v, w))
    u = u.float()
    s = state.float()
    y = _new_y(B, H, S, dh, r.device)
    for t in range(S):
        r_t, k_t, v_t, w_t = r[:, :, t], k[:, :, t], v[:, :, t], w[:, :, t]
        bonus = (r_t * u * k_t).sum(dim=-1, keepdim=True)      # (B, H, 1)
        y[:, :, t] = torch.einsum("bhi,bhij->bhj", r_t, s) + bonus * v_t
        s = w_t[..., None] * s + k_t[..., None] * v_t[:, :, None, :]
    if out_state is None:
        return y, s
    out_state.copy_(s)
    return y, out_state


def rwkv6_chunkwise_plain(r, k, v, w, u, state, *, out_state=None,
                          chunk=CHUNK):
    """The chunked form the kernel computes for sequences of ``CHUNK`` or
    more steps, in plain PyTorch: for each chunk of ``chunk`` steps from
    the carried state S0, with l_t = max(log2 w_t, LOG2_FLOOR) and
    L_t = l_0 + ... + l_t (L_-1 = 0),

        y_t = (r_t 2^L_{t-1}) S0 + sum_{s<t} A_ts v_s + (r_t . (u k_t)) v_t,
        A_ts = sum_i r_t[i] k_s[i] 2^(L_{t-1}[i] - L_s[i]),
        S_C = diag(2^L_{C-1}) S0 + (k_s 2^(L_{C-1} - L_s))^T V,

    in the kernel's order of terms (inter-chunk, then A V with the bonus on
    A's diagonal).  Products are float32; the exponents are float64, as
    accurate as the kernel's compensated float32 pairs.  Same arguments and
    result as :func:`rwkv6_chunked`.  Nothing on the main path calls it:
    the tests use it to hold the algebra against the step-by-step form."""
    B, H, S, dh = r.shape
    r, k, v = (t.float() for t in (r, k, v))
    u = u.float()
    s = state.float()
    lw = torch.log2(w.double())
    lw = torch.where(lw < LOG2_FLOOR, LOG2_FLOOR, lw)      # a NaN stays
    y = _new_y(B, H, S, dh, r.device)
    for t0 in range(0, S, chunk):
        sl = slice(t0, min(t0 + chunk, S))
        n = sl.stop - t0
        r_c, k_c, v_c = r[:, :, sl], k[:, :, sl], v[:, :, sl]
        lam = lw[:, :, sl].cumsum(dim=2)                       # L_t
        lam_q = torch.cat([torch.zeros_like(lam[:, :, :1]), lam[:, :, :-1]],
                          dim=2)                                # L_{t-1}
        inter = (r_c * torch.exp2(lam_q).float()) @ s
        diff = lam_q[:, :, :, None] - lam[:, :, None]           # (t, s, i)
        lower = torch.ones(n, n, dtype=torch.bool, device=r.device).tril(-1)
        diff = torch.where(lower[:, :, None], diff, -torch.inf)
        a = torch.einsum("bhti,bhsi,bhtsi->bhts", r_c, k_c,
                         torch.exp2(diff).float())
        a = a + torch.diag_embed((r_c * u[:, None] * k_c).sum(dim=-1))
        y[:, :, sl] = inter + a @ v_c
        kd = k_c * torch.exp2(lam[:, :, -1:] - lam).float()
        s = torch.exp2(lam[:, :, -1]).float()[..., None] * s \
            + kd.transpose(-1, -2) @ v_c
    if out_state is None:
        return y, s
    out_state.copy_(s)
    return y, out_state


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

_PTR, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


# ctypes argument types of the entry point, as ``csrc/rwkv6.cu`` declares it
_SIGNATURES = {"rwkv6_launch": [_PTR] * 8 + [_INT] * 6 + [_I64] * 20 + [_PTR]}


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load("rwkv6").rwkv6_launch
    fn.argtypes = _SIGNATURES["rwkv6_launch"]
    fn.restype = _INT
    return fn


def _check(r, k, v, w, u, state, out_state):
    B, H, S, dh = r.shape
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.shape != r.shape:
            raise ValueError(f"{name} must be (B, H, S, dh) = "
                             f"{tuple(r.shape)}; got {tuple(t.shape)}")
    if u.shape != (H, dh):
        raise ValueError(f"u must be ({H}, {dh}); got {tuple(u.shape)}")
    for name, t in (("state", state), ("out_state", out_state)):
        if t is not None and t.shape != (B, H, dh, dh):
            raise ValueError(f"{name} must be ({B}, {H}, {dh}, {dh}); got "
                             f"{tuple(t.shape)}")
    if S < 1:
        raise ValueError("the sequence must hold at least one step")
    for t in (k, v, w, u, state) + ((out_state,) if out_state is not None
                                     else ()):
        if t.device != r.device:
            raise ValueError(f"a tensor is on {t.device}, r on {r.device}")
    return B, H, S, dh


def _check_kernel_inputs(r, k, v, w, u, state, out_state, dh):
    if r.dtype not in _DTYPE_CODES or k.dtype != r.dtype \
            or v.dtype != r.dtype:
        raise ValueError(f"kernel takes float32 or bfloat16 r/k/v of one "
                         f"dtype; got {r.dtype}, {k.dtype}, {v.dtype}")
    if u.dtype not in _DTYPE_CODES:
        raise ValueError(f"kernel takes float32 or bfloat16 u; got "
                         f"{u.dtype}")
    for name, t in (("w", w), ("state", state), ("out_state", out_state)):
        if t.dtype != torch.float32:
            raise ValueError(f"kernel takes a float32 {name}; got {t.dtype}")
    if dh not in SUPPORTED_DH:
        raise ValueError(f"kernel supports dh in {SUPPORTED_DH}, got {dh}")
    if any(t.stride(3) != 1 for t in (r, k, v, w)) or u.stride(1) != 1:
        raise ValueError("r, k, v, w and u need a unit stride on dh")
    for name, t in (("state", state), ("out_state", out_state)):
        if t.stride(3) != 1 or t.stride(2) != dh:
            raise ValueError(f"{name} needs dense (dh, dh) matrices")
    if r.shape[2] >= CHUNK and not all(map(build.aligned16, (r, k, v, w))):
        raise ValueError("the chunked kernel (S >= 16) needs 16-byte "
                         "aligned bases and strides for r, k, v and w")


def rwkv6_chunked(r, k, v, w, u, state, *, out_state=None):
    """The WKV6 recurrence over S time steps for every (b, h).

    r, k, v: (B, H, S, dh) in float32 or bfloat16, any strides with a unit
    last one (the model passes transposed views of its (B, S, H, dh)
    activations); w: the same shape in float32, the per-channel decay in
    [0, 1]; u: (H, dh) bonus, float32 or bfloat16; state: (B, H, dh, dh)
    float32, S[i, j] = key channel i, value channel j.  ``out_state``, if
    given, receives the final state and may be ``state`` itself (each
    (b, h) state is read whole before it is written).  On the card, S >=
    ``CHUNK`` needs 16-byte aligned bases and strides for r, k, v and w, as
    every view of a model activation has.

    Returns y (B, H, S, dh) float32 — a view of (B, S, H, dh) memory — and
    the final state (``out_state``, or a new tensor)."""
    B, H, S, dh = _check(r, k, v, w, u, state, out_state)
    refuse_autograd("the WKV6 kernel", r, k, v, w, u, state)
    if r.device.type == "cpu":
        return rwkv6_chunked_plain(r, k, v, w, u, state,
                                   out_state=out_state)
    if r.device.type != "cuda":
        raise ValueError(f"no kernel for device {r.device}")
    if out_state is None:
        out_state = torch.empty((B, H, dh, dh), dtype=torch.float32,
                                device=r.device)
    _check_kernel_inputs(r, k, v, w, u, state, out_state, dh)
    y = _new_y(B, H, S, dh, r.device)
    if B * H == 0:
        return y, out_state
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = _launcher()(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), state.data_ptr(), y.data_ptr(),
            out_state.data_ptr(), B, H, S, dh, _DTYPE_CODES[r.dtype],
            _DTYPE_CODES[u.dtype],
            *(s for t in (r, k, v, w, y) for s in t.stride()[:3]),
            u.stride(0), state.stride(0), state.stride(1),
            out_state.stride(0), out_state.stride(1), stream)
    if err:
        raise RuntimeError(f"rwkv6_chunked launch failed: cudaError {err}")
    rwkv6_chunked.launches += 1
    return y, out_state


rwkv6_chunked.launches = 0
