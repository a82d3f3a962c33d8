"""Exact k nearest neighbours within a point cloud, for GDC.

Kernel: `csrc/knn.cu`, which replaces the TPU kernel
`fusiondepth_tpu/gdc/pallas_knn.py::knn_pallas`. For each of the N points
of an (N, 3) float32 cloud, the indices (int32) of its k nearest other
points, sorted by (squared distance, index): the contract of
`fusiondepth_tpu/gdc/gdc.py::knn_brute`, whose lax.top_k breaks ties
toward the lower index. Squared distances are |q|^2 - 2 q.c + |c|^2 in
float32, rounded as JAX rounds them on a CPU; padded points must
already sit at far sentinel coordinates. N need not be a multiple of any tile. Bound by
operations.
"""

from __future__ import annotations

import torch

from fusiondepth_torch.kernels import LAUNCHES, build, check_cuda, \
    on_card

MAX_K = 16
QUERY_CHUNK = 512  # query rows per step of the plain version


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c rounded once: the float64 product is exact, the
    float64 sum rounds once more (a tie that double rounding would break
    otherwise is as rare as 2^-29)."""
    return (a.double() * b.double() + c.double()).float()


def _sqnorm(p: torch.Tensor) -> torch.Tensor:
    return _fma(p[:, 2], p[:, 2], _fma(p[:, 1], p[:, 1], p[:, 0] * p[:, 0]))


def knn_plain(points: torch.Tensor, k: int = 10,
              chunk: int = QUERY_CHUNK) -> torch.Tensor:
    """Plain version: per chunk of queries, the (chunk, N) squared
    distances (|q|^2 - 2 q.c) + |c|^2, rounded as the kernel and XLA's
    CPU code round them (|p|^2 = fma(z, z, fma(y, y, x * x)), q.c =
    fma(q2, c2, fma(q1, c1, q0 * c0))), self set to
    +inf, then the k smallest by a stable sort, so that ties go to the
    lower index. Never builds the (N, N) matrix."""
    N = points.shape[0]
    sq = _sqnorm(points)
    out = []
    for lo in range(0, N, chunk):
        q = points[lo:lo + chunk]
        qc = _fma(q[:, 2:3], points[:, 2], _fma(
            q[:, 1:2], points[:, 1], q[:, 0:1] * points[:, 0]))
        d2 = (_sqnorm(q)[:, None] - 2.0 * qc) + sq[None, :]
        rows = torch.arange(q.shape[0], device=points.device)
        d2[rows, lo + rows] = float("inf")
        idx = torch.sort(d2, dim=1, stable=True)[1][:, :k]
        out.append(idx.to(torch.int32))
    return torch.cat(out)


def knn(points: torch.Tensor, k: int = 10) -> torch.Tensor:
    """(N, k) int32 neighbour indices of the (N, 3) cloud, excluding each
    point itself. CPU tensors take the plain version; CUDA tensors take
    the kernel (float32, contiguous)."""
    if points.dim() != 2 or points.shape[1] != 3:
        raise ValueError(f"knn: points must be (N, 3), got "
                         f"{tuple(points.shape)}")
    N = points.shape[0]
    if not 1 <= k <= min(MAX_K, N - 1):
        raise ValueError(f"knn: k={k} must be in 1..{min(MAX_K, N - 1)} "
                         f"for {N} points")
    if points.device.type == "cpu":
        return knn_plain(points, k)
    name = "knn"
    check_cuda(name, torch.float32, points=points)
    lib = build.load()
    splits = lib.fd_knn_splits(N, k)
    if splits < 1:
        raise RuntimeError(f"fd_knn_splits: no split count for N={N}, k={k}")
    part_d = torch.empty((splits, N, k), device=points.device,
                         dtype=torch.float32)
    part_i = torch.empty((splits, N, k), device=points.device,
                         dtype=torch.int32)
    out = torch.empty((N, k), device=points.device, dtype=torch.int32)
    with on_card(points) as stream:
        build.check(lib.fd_knn(points.data_ptr(), N, k, part_d.data_ptr(),
                               part_i.data_ptr(), out.data_ptr(), stream),
                    "fd_knn")
    LAUNCHES[name] += 1
    return out
