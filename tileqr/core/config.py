"""QR configuration (SURVEY.md §5 "Config/flag system").

The reference exposes matrix size / tile size through argv [SURVEY.md §5,
INFERRED]; here the equivalent is a small frozen dataclass threaded through
the drivers. Hashable so it can be a static argument under ``jax.jit``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax.numpy as jnp


def mesh_shape_for(n_devices: int) -> Tuple[int, int]:
    """(pr, pc) for ``n_devices``: the widest factorization with pr >= pc.
    GPUs of one host are joined all to all, so the mesh follows the
    algorithm (a near-square 2D block-cyclic grid) alone."""
    pc = 1
    for cand in range(int(n_devices**0.5), 0, -1):
        if n_devices % cand == 0:
            pc = cand
            break
    return n_devices // pc, pc


@dataclasses.dataclass(frozen=True)
class QRConfig:
    """Configuration for tiled QR runs.

    Attributes:
      nb: tile size (square nb×nb tiles); 256 is the acceptance-config
        value (BASELINE.json:8). Must be a multiple of 8.
      dtype: compute dtype (fp32 is the acceptance dtype).
      precision: matmul precision of every trailing update and reflector
        apply. "highest" (full float32 — the acceptance default; the GPU
        runs it as SGEMM) keeps the ≤1e-6 full-width residual gate.
        "high"/"default" allow reduced-precision products (TF32 on the GPU)
        and are for experiments only. The panel factorizations always run
        at full precision.
      chunk: sub-diagonal couple height in tiles for the square driver
        (kernels/tile_ops.couple_bounds): 1 reproduces the reference's
        flat-tree tile algebra exactly; 0 eliminates the whole
        sub-diagonal of a panel in one couple.
      mesh_shape: (rows, cols) for the sharded drivers; None derives it
        from the visible device count (``mesh_shape_for``).
      prescale: divide A by an exact power-of-2 ≥ max|A| before factoring
        and fold the scale back into R. Lifts the fp32 input-magnitude
        limit (column norms overflow for entries ≳1e19) at the cost of one
        extra pass over A. Exact: QR commutes with scalar scaling,
        power-of-2 division is lossless, and the Householder reflectors
        are scale-invariant. Default off to keep the hot path traffic-free.

    Elimination-tree selection is implicit per path (matching the reference,
    SURVEY.md §2.3): the square driver uses the flat chain (chunked), the
    tall-skinny path the TSQR tree, and the sharded driver a hierarchy of
    local chains + a binary TTQRT tree across mesh rows.
    """

    nb: int = 256
    # Batched-path algorithm: "hh" = batched Householder (unconditionally
    # stable); "cholqr2" = batched CholeskyQR2 (drivers/cholqr.py: one
    # batched Cholesky + matmul-only inverse and orthogonality correction;
    # requires cond(A)²·eps < 1, i.e. cond ≲ 1e3 in fp32).
    batched_method: str = "hh"
    # Square-path panel algorithm: "hh" = tiled Householder panels (the
    # unconditionally stable default, drivers/square.py); "hr" = CholeskyQR2
    # panels + Householder reconstruction (drivers/square_hr.py: matmul-only
    # panels, the serial work shrinks to one nb×nb modified LU per panel —
    # for well-conditioned matrices, cond(A) ≲ 1e3 in fp32).
    square_method: str = "hh"
    # hr breakdown guard (square_method="hr" only). The hr/CholeskyQR2 panel
    # factorization has a conditioning contract (cond(panel)²·eps ≪ 1); each
    # panel's round-1 orthogonality defect ‖Q₁ᵀQ₁ − I‖_max is a nearly-free
    # breakdown monitor (an observer reduce on an already-computed
    # intermediate — results are bitwise-unchanged). Policy when the max
    # defect exceeds hr_guard_tau (or is NaN):
    #   "fallback": warn and refactor with the unconditionally stable
    #     Householder path (the hr work is discarded — breakdown is the
    #     rare case, paying 2× there beats silently wrong factors);
    #   "warn": warn, keep the hr factors (caller opted into the contract);
    #   "off": no check (no host sync; also the behavior whenever qr_factor
    #     is called inside a jax.jit trace, where a host check is
    #     impossible — HRFactors.health still carries the device scalar).
    hr_guard: str = "fallback"
    # Guard threshold on ‖Q₁ᵀQ₁ − I‖_max. The correction round leaves
    # O(‖E‖⁴) orthogonality error (truncated chol(I+E) iteration + cubic
    # Neumann inverse), so ≤1e-6 backward error needs ‖E‖ ≲ 0.03–0.05;
    # gaussian panels measure ‖E‖ ~ 1e-4 and true breakdowns blow past 1
    # (or NaN), so the gate sits in a wide, empirically-calibrated gap
    # (tests/test_square_hr.py guard tests).
    hr_guard_tau: float = 0.05
    chunk: int = 0
    dtype: jnp.dtype = jnp.float32
    precision: str = "highest"
    mesh_shape: Optional[Tuple[int, int]] = None
    prescale: bool = False

    def __post_init__(self):
        if self.nb % 8 != 0:
            raise ValueError(f"nb={self.nb} must be a multiple of 8")
        if self.chunk < 0:
            raise ValueError(f"chunk={self.chunk} must be >= 0")
        if self.precision not in ("highest", "high", "default"):
            raise ValueError(
                f"precision={self.precision!r} must be highest|high|default"
            )
        if self.square_method not in ("hh", "hr"):
            raise ValueError(
                f"square_method={self.square_method!r} must be hh|hr"
            )
        if self.hr_guard not in ("fallback", "warn", "off"):
            raise ValueError(
                f"hr_guard={self.hr_guard!r} must be fallback|warn|off"
            )

    def replace(self, **kw) -> "QRConfig":
        return dataclasses.replace(self, **kw)


DEFAULT = QRConfig()
