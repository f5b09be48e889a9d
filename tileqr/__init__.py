"""tileqr — tiled QR decomposition in JAX, compiled for the GPU by XLA.

The capability surface of the CUDA project
``s10m/GPU-Tiled-QR-Decomposition`` (see SURVEY.md; parity is defined by
SURVEY.md §2 / BASELINE.json:5): blocked Householder QR built from the
classic tile algebra — GEQRT panel factorization (geqrf: cuSOLVER on the
GPU) with compact-WY V/T, GEMM trailing updates (LARFB/SSRFB: cuBLAS), a
communication-avoiding TSQR/TTQRT tree for tall-skinny matrices — plus
explicit Q formation (ORGQR), QR-based least squares, a batched path, and
2D block-cyclic sharding via ``shard_map`` with XLA collectives (NCCL).

Public API
----------
- :func:`tileqr.qr` — blocked tiled QR, returns (Q, R) or packed factors.
- :func:`tileqr.qr_factor` — factor only; returns :class:`QRFactors`.
- :func:`tileqr.tsqr` — tall-skinny tree QR.
- :func:`tileqr.qr_batched` — vmapped batched QR.
- :func:`tileqr.orgqr` / :func:`tileqr.apply_q` — form/apply Q.
- :func:`tileqr.lstsq` — QR-based least squares.
- :func:`tileqr.qr_sharded` — 2D block-cyclic multi-device QR; consume its
  distributed factors with :func:`tileqr.assemble_r_sharded` /
  :func:`tileqr.apply_q_sharded`.
- :class:`tileqr.QRConfig` — tile/tree/precision configuration.
- :class:`tileqr.QRFactors` / :class:`tileqr.HRFactors` /
  :class:`tileqr.TSQRFactors` — the packed factor pytrees returned by
  :func:`qr_factor` and :func:`tsqr` (``mode="factor"``), for isinstance
  routing before :func:`apply_q` / :func:`orgqr`.
"""

from tileqr.core.config import QRConfig
from tileqr.api import (
    HRFactors,
    QRFactors,
    TSQRFactors,
    apply_q,
    lstsq,
    orgqr,
    qr,
    qr_batched,
    qr_factor,
    tsqr,
)
from tileqr.drivers.sharded import (
    apply_q_sharded,
    assemble_r_sharded,
    qr_sharded,
)
from tileqr.utils.verify import orth_streamed, qr_check, relerr_streamed

__version__ = "0.1.0"

__all__ = [
    "HRFactors",
    "QRConfig",
    "QRFactors",
    "TSQRFactors",
    "apply_q",
    "apply_q_sharded",
    "assemble_r_sharded",
    "lstsq",
    "orgqr",
    "orth_streamed",
    "qr",
    "qr_batched",
    "qr_check",
    "qr_factor",
    "qr_sharded",
    "relerr_streamed",
    "tsqr",
    "__version__",
]
