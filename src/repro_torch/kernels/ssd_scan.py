"""``ssd_scan``: the Mamba2 SSD chunk scan (forward).

Replaces the TPU kernel ``repro.kernels.ssd_scan.ssd_scan_pallas`` with the
hand-written CUDA kernel ``csrc/ssd_scan.cu`` (its header gives the design
and the bound).  The wrapper takes the reference's layout — x ``[B, S, H,
P]`` (bfloat16 or float32), dt ``[B, S, H]`` float32 (after softplus), A
``[H]`` float32 (< 0), B and C ``[B, S, G, N]`` (bfloat16 or float32) —
and returns ``(y [B, S, H, P]`` in x's dtype, ``h_final [B, H, P, N]``
float32), in one call of the op (three kernels, chunk states, the carry
over chunks and the outputs, counted as one launch).  A ragged last chunk
needs no padding.

On a CUDA tensor it launches the kernel, or raises; on a CPU tensor it
runs the plain version, the model's own
:func:`repro_torch.models.ssm.ssd_chunked`.  The two agree to a tolerance: the chunked
recurrence reassociates.  On a ``meta`` tensor it returns the outputs'
shapes and dtypes and computes nothing (the dry run).  :func:`cost` is
the kernel's FLOPs and bytes: its roofline bound, and what it adds to an
active ``launch.op_analysis`` count on every device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, cost as kcost

NAME = "ssd_scan"
PEAK_FLOPS = kcost.TF32_FLOPS      # split-TF32 products on mma.sync
DTYPES = (torch.float32, torch.bfloat16)
MAX_SHARED_BYTES = 232448     # dynamic shared memory a Hopper block may use
MAX_P = 128                   # head dim: the outputs kernel keeps a row's P
                              # outputs in registers
MAX_STATE_TILES = 128         # 16 x 8 tiles of a chunk state [P, N]


def _check(x, dt, A, Bm, Cm, chunk: int) -> None:
    if x.dtype not in DTYPES or Bm.dtype not in DTYPES \
            or Cm.dtype != Bm.dtype \
            or (Bm.dtype == torch.bfloat16 and x.dtype != torch.bfloat16):
        raise TypeError(f"x and B/C must be float32 or bfloat16 (B and C "
                        f"alike, bfloat16 only with a bfloat16 x), got "
                        f"{x.dtype}/{Bm.dtype}/{Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32, got {dt.dtype}/{A.dtype}")
    if x.ndim != 4 or Bm.ndim != 4 or Bm.shape != Cm.shape:
        raise ValueError(f"x must be [B, S, H, P] and B, C one [B, S, G, N] "
                         f"shape, got {tuple(x.shape)}/{tuple(Bm.shape)}/"
                         f"{tuple(Cm.shape)}")
    Bsz, S, H, P = x.shape
    G = Bm.shape[2]
    if dt.shape != (Bsz, S, H) or A.shape != (H,) \
            or Bm.shape[:2] != (Bsz, S) or G < 1 or H % G:
        raise ValueError(f"shapes do not fit x {tuple(x.shape)}: dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B/C "
                         f"{tuple(Bm.shape)} (H % G == 0)")
    if S < 1:
        raise ValueError("ssd_scan needs S >= 1")
    if isinstance(chunk, bool) or not isinstance(chunk, int) or chunk < 1:
        raise ValueError(f"chunk must be an int >= 1, got {chunk!r}")
    if not (x.device == dt.device == A.device == Bm.device == Cm.device):
        raise ValueError("x, dt, A, B and C must lie on one device")
    build.refuse_grad(NAME, x=x, dt=dt, A=A, B=Bm, C=Cm)


def cost(x, dt, A, Bm, Cm, chunk: int) -> tuple[int, int]:
    """``(flops, bytes)`` of one call: C.B over the causal pairs of each
    chunk once per group (it does not depend on the head); per head M.x
    over the pairs, the state update and the inflow; the inputs read
    once, y and h_final written once."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, S)
    full, rest = divmod(S, Q)
    pairs = full * Q * (Q + 1) // 2 + rest * (rest + 1) // 2
    flops = B * (G * 2 * pairs * N + H * (2 * pairs * P + 4 * S * P * N))
    moved = (2 * x.numel() * x.element_size() + dt.numel() * 4
             + (Bm.numel() + Cm.numel()) * Bm.element_size()
             + A.numel() * 4 + B * H * P * N * 4)
    return flops, moved


def _launch(x, dt, A, Bm, Cm, chunk: int):
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", Bm), ("C", Cm)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, S)
    nc = -(-S // Q)
    x_bf16, bc_bf16 = x.dtype == torch.bfloat16, Bm.dtype == torch.bfloat16
    lib = build.load(NAME)
    lib.ssd_scan_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.ssd_scan_smem_bytes.restype = ctypes.c_longlong
    smem = lib.ssd_scan_smem_bytes(P, N, Q, int(x_bf16), int(bc_bf16))
    tiles = -(-P // 16) * -(-N // 8)
    if P > MAX_P or tiles > MAX_STATE_TILES or smem > MAX_SHARED_BYTES:
        raise ValueError(f"ssd_scan: P={P}, N={N}, chunk={Q} exceed the "
                         f"kernel (P <= {MAX_P}, {tiles} state tiles of "
                         f"16 x 8 <= {MAX_STATE_TILES}, {smem} B of shared "
                         f"memory <= {MAX_SHARED_BYTES})")
    if max(x.numel(), Bm.numel(), Bsz * nc * H * P * N) >= 2**31 \
            or max(Bsz, H) > 65535:
        raise ValueError("ssd_scan: sizes exceed the kernel's indexing or "
                         "grid")
    fn = lib.ssd_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    y = torch.empty_like(x)
    h = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    states = torch.empty((Bsz, nc, H, P, N), dtype=torch.float32,
                         device=x.device)
    cum = torch.empty((Bsz, H, nc * Q), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
             Cm.data_ptr(), y.data_ptr(), h.data_ptr(), states.data_ptr(),
             cum.data_ptr(), Bsz, S, H, G, P, N, Q, int(x_bf16),
             int(bc_bf16), stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    build.count_launch(NAME)
    return y, h


def _run(x, dt, A, Bm, Cm, chunk: int):
    if x.device.type == "cuda":
        return _launch(x, dt, A, Bm, Cm, chunk)
    if x.device.type == "cpu":
        # imported here: the model imports the kernels
        from repro_torch.models.ssm import ssd_chunked
        return ssd_chunked(x, dt, A, Bm, Cm, chunk)
    Bsz, _, H, P = x.shape
    return (torch.empty_like(x),
            torch.empty((Bsz, H, P, Bm.shape[3]), dtype=torch.float32,
                        device=x.device))


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = 64
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(y, h_final)`` of the SSD recurrence over chunks of ``chunk`` steps.

    x ``[B, S, H, P]``, dt ``[B, S, H]``, A ``[H]``, B/C ``[B, S, G, N]``
    -> y ``[B, S, H, P]`` (x's dtype), h_final ``[B, H, P, N]`` float32.
    The kernel on CUDA tensors, the plain version on CPU tensors, the
    outputs' shapes and dtypes on ``meta`` tensors.
    """
    _check(x, dt, A, Bm, Cm, chunk)
    if x.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"ssd_scan: no kernel for device {x.device}")
    if kcost.ACTIVE:
        return kcost.counted(NAME, lambda: cost(x, dt, A, Bm, Cm, chunk),
                             _run, x, dt, A, Bm, Cm, chunk)
    return _run(x, dt, A, Bm, Cm, chunk)
