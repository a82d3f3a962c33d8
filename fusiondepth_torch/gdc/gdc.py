"""Graph-based Depth Correction (GDC) in PyTorch (counterpart of
`fusiondepth_tpu/gdc/gdc.py`; the math of the reference solver
gdc_old.py:74-250, from Pseudo-LiDAR++).

LLE-style reconstruction weights from the k nearest neighbours of each
point in rect-camera 3D space, then a least-squares solve that moves the
pseudo-LiDAR depths so that each point is reconstructed by its neighbours
while the LiDAR-anchored points stay at ground truth. As in the JAX
package, everything is fixed-shape: masked points are gathered into
capacities cap_pl and cap_l (padded with sentinels and a validity mask),
the KNN is the exact kernel of `kernels/knn.py`, the (k+2)^2 systems are
one batched solve, and the normal equations run through a matrix-free
gather / segment-sum matvec in conjugate gradients. Every sum has a fixed
order, so a card gives the same correction on every run.

The conjugate gradients are `jax.scipy.sparse.linalg.cg`'s algorithm
(`_cg_solve`): x0 given, r0 = b - A x0, stop once r.r <= max(tol^2 b.b,
atol^2) or after maxiter iterations, with its update order. The stopping
test reads r.r back to the host once per iteration (one sync each), so
the loop ends where JAX's while_loop ends and the iteration count is
known (`return_info`).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from fusiondepth_torch.kernels import knn as knn_kernel

# far-away sentinel for padded points: never a nearest neighbour of real ones
_SENTINEL = 1e8


class GDCCalib(NamedTuple):
    """Unprojection parameters (image uv + depth -> rect XYZ), floats."""

    c_u: float
    c_v: float
    f_u: float
    f_v: float
    b_x: float
    b_y: float

    @staticmethod
    def from_calibration(calib) -> "GDCCalib":
        return GDCCalib(*[float(np.float32(v)) for v in (
            calib.c_u, calib.c_v, calib.f_u, calib.f_v, calib.b_x,
            calib.b_y)])


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(np.float32(v), dtype=torch.float32,
                        device=like.device)


def depth_to_points(depth: torch.Tensor, calib: GDCCalib) -> torch.Tensor:
    """(H, W) depth -> (H*W, 3) rect-camera points (gdc_old.py:66-71)."""
    H, W = depth.shape
    u = torch.arange(W, dtype=torch.float32, device=depth.device)[None, :]
    v = torch.arange(H, dtype=torch.float32, device=depth.device)[:, None]
    z = depth
    x = (u - _f32(calib.c_u, z)) * z / _f32(calib.f_u, z) + \
        _f32(calib.b_x, z)
    y = (v - _f32(calib.c_v, z)) * z / _f32(calib.f_v, z) + \
        _f32(calib.b_y, z)
    return torch.stack([x.reshape(-1), y.reshape(-1), z.reshape(-1)], dim=1)


def frustum_mask(ptc: torch.Tensor) -> torch.Tensor:
    """z in (1, 80), x in [-40, 40), y in [-1, 2.5) (gdc_old.py:18-26)."""
    return ((ptc[:, 2] < 80) & (ptc[:, 2] > 1) & (ptc[:, 0] < 40)
            & (ptc[:, 0] >= -40) & (ptc[:, 1] < 2.5) & (ptc[:, 1] >= -1))


def _radians(deg: float) -> np.float32:
    """jnp.radians of a Python float: the product in float32."""
    return np.float32(deg) * np.float32(np.pi / 180)


def pitch_mask(ptc: torch.Tensor, low: float, high: float) -> torch.Tensor:
    """Pitch-angle band arcsin(y/|p|) in [low, high) rad
    (gdc_old.py:55-63)."""
    d = torch.linalg.vector_norm(ptc, dim=1)
    theta = torch.arcsin(ptc[:, 1] / torch.clamp(d, min=1e-9))
    return (theta >= _f32(low, ptc)) & (theta < _f32(high, ptc))


def knn_brute(points: torch.Tensor, k: int = 10) -> torch.Tensor:
    """Exact k nearest neighbours (excluding self), (N, k) int32, ties to
    the lower index: the KNN kernel on a card, its plain version (chunked
    expansion and a stable sort) on the CPU. Invalid points must already
    sit at the far sentinel."""
    return knn_kernel.knn(points, k)


def lle_weights(x_info: torch.Tensor, neighbors: torch.Tensor,
                valid: torch.Tensor, W_tol: float) -> torch.Tensor:
    """Per-point reconstruction weights from the neighbours' depths: the
    (k+2) x (k+2) KKT system of the reference (gdc_old.py:178-188),
    Tikhonov-regularized weights that reconstruct x_i from its neighbours
    and sum to 1, in one batched solve. Invalid rows solve the identity
    and get weight 0. x_info (N,), neighbors (N, k), valid (N,) ->
    (N, k)."""
    N, k = neighbors.shape
    dt = x_info.dtype
    xn = x_info[neighbors.long()]
    A = torch.zeros((N, k + 2, k + 2), dtype=dt, device=x_info.device)
    A[:, :k, :k] = torch.eye(k, dtype=dt, device=x_info.device) * \
        (1.0 + W_tol)
    A[:, k + 1, :k] = 1.0
    A[:, :k, k + 1] = 1.0
    A[:, k, :k] = xn
    A[:, :k, k] = xn
    b = torch.zeros((N, k + 2), dtype=dt, device=x_info.device)
    b[:, k] = x_info
    b[:, k + 1] = 1.0
    eye = torch.eye(k + 2, dtype=dt, device=x_info.device)
    A = torch.where(valid[:, None, None], A, eye)
    W = torch.linalg.solve(A, b[..., None])[..., 0][:, :k]
    return torch.where(valid[:, None], W, torch.zeros_like(W))


def _make_matvecs(W: torch.Tensor, neighbors: torch.Tensor, n_pl: int,
                  valid: torch.Tensor):
    """Matrix-free A x and A^T y for A = [I - W_PLPL; W_PLL]
    (gdc.py:_make_matvecs). W, neighbors: (N, k) over the concatenated
    [PL, L] ordering; the unknowns are the first n_pl entries."""
    N, k = W.shape
    nb = neighbors.long()
    nb_is_pl = (nb < n_pl) & valid[nb] & valid[:, None]
    W_pl = torch.where(nb_is_pl, W, torch.zeros_like(W))
    nb_clip = torch.clamp(nb, 0, N - 1)
    seg2 = torch.clamp(nb_clip, 0, n_pl - 1)
    seg = seg2.reshape(-1)
    in_range = (nb_clip < n_pl).reshape(-1)
    sign = torch.where(torch.arange(N, device=W.device) < n_pl, -1.0,
                       1.0).to(W.dtype)
    # segment_sum as a sum over each segment in source order (the order
    # of JAX's scatter-add on a CPU), without atomics, so that a card
    # gives the same sums on every run
    order = torch.argsort(seg, stable=True)
    counts = torch.bincount(seg, minlength=n_pl)

    def A_mv(x):
        wx = (W_pl * x[seg2]).sum(-1)
        return torch.cat([x - wx[:n_pl], wx[n_pl:]])

    def AT_mv(y):
        contrib = (W_pl * (sign * y)[:, None]).reshape(-1)
        contrib = torch.where(in_range, contrib, torch.zeros_like(contrib))
        out = torch.segment_reduce(contrib[order], "sum", lengths=counts,
                                   unsafe=True)
        return y[:n_pl] + out

    return A_mv, AT_mv


def cg(A, b: torch.Tensor, x0: torch.Tensor, tol: float = 1e-5,
       atol: float = 0.0, maxiter: int = 200):
    """Conjugate gradients of jax.scipy.sparse.linalg.cg (no
    preconditioner): returns (x, iterations)."""
    bs = torch.dot(b, b)
    atol2 = torch.clamp(tol * tol * bs, min=atol * atol)
    x = x0
    r = b - A(x0)
    p = r
    gamma = torch.dot(r, r)
    k = 0
    while k < maxiter and bool(gamma > atol2):
        Ap = A(p)
        alpha = gamma / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        gamma_ = torch.dot(r, r)
        beta = gamma_ / gamma
        p = r + beta * p
        gamma = gamma_
        k += 1
    return x, k


def _nonzero_fixed(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """jnp.nonzero(mask, size=size, fill_value=fill)[0]: the first `size`
    indices of True in row-major order, padded with `fill`."""
    idx = torch.nonzero(mask).reshape(-1)[:size]
    out = torch.full((size,), fill, dtype=torch.long, device=mask.device)
    out[:idx.numel()] = idx
    return out


def gdc_correct(pred_depth: torch.Tensor, gt_depth: torch.Tensor,
                calib: GDCCalib, k: int = 10, W_tol: float = 3e-5,
                recon_tol: float = 5e-4,
                consider_range: Tuple[float, float] = (-0.1, 4.0),
                depth_agree: float = 2.0, cap_pl: int = 32768,
                cap_l: int = 8192, maxiter: int = 200,
                return_info: bool = False):
    """Refine `pred_depth` (H, W) with sparse `gt_depth` (H, W) anchors on
    the tensors' device, in float32 (consider_range in degrees). Returns
    the corrected (H, W) depth map, the exact LiDAR pasted where gt > 0
    (gdc_old.py:236-241). With return_info also {"n_pl", "n_l",
    "overflow", "cg_iters"}: the masked point counts, whether they
    exceeded cap_pl / cap_l (points beyond a capacity are dropped, as
    jnp.nonzero(size=...) drops them), and the CG iterations taken."""
    H, W = pred_depth.shape
    HW = H * W
    pred = pred_depth.to(torch.float32)
    gt = gt_depth.to(torch.float32)
    pred_flat, gt_flat = pred.reshape(-1), gt.reshape(-1)

    ptc = depth_to_points(pred, calib)
    ptc_gt = depth_to_points(gt, calib)
    consider_pl = frustum_mask(ptc) & pitch_mask(
        ptc, _radians(consider_range[0]), _radians(consider_range[1]))
    consider_l = frustum_mask(ptc_gt)
    gt_mask = (consider_l & consider_pl
               & (torch.abs(pred_flat - gt_flat) < depth_agree))
    pred_mask = consider_pl & ~gt_mask

    idx_pl = _nonzero_fixed(pred_mask, cap_pl, HW)
    idx_l = _nonzero_fixed(gt_mask, cap_l, HW)
    n_pl_actual = pred_mask.sum()
    n_l_actual = gt_mask.sum()
    dev = pred.device
    valid_pl = torch.arange(cap_pl, device=dev) < n_pl_actual
    valid_l = torch.arange(cap_l, device=dev) < n_l_actual
    valid = torch.cat([valid_pl, valid_l])

    def take(flat, idx):
        v = flat[torch.clamp(idx, 0, HW - 1)]
        return torch.where(idx < HW, v, torch.zeros_like(v))

    x_info = torch.cat([take(pred_flat, idx_pl), take(pred_flat, idx_l)])
    gt_info = take(gt_flat, idx_l)

    sentinel = torch.full((), _SENTINEL, dtype=torch.float32, device=dev)
    pts = torch.cat([
        torch.where(valid_pl[:, None], ptc[torch.clamp(idx_pl, 0, HW - 1)],
                    sentinel),
        torch.where(valid_l[:, None], ptc[torch.clamp(idx_l, 0, HW - 1)],
                    sentinel)])
    # spread padded points so they are not each other's zero-distance pairs
    N = cap_pl + cap_l
    spread = torch.arange(N, dtype=torch.float32, device=dev)[:, None] * \
        torch.tensor([[1.0, 0.0, 0.0]], device=dev)
    pts = torch.where(valid[:, None], pts, pts + spread).contiguous()

    neighbors = knn_brute(pts, k=k).long()
    Wmat = lle_weights(x_info, neighbors, valid, W_tol)
    A_mv, AT_mv = _make_matvecs(Wmat, neighbors, cap_pl, valid)

    # b = [W_LPL gt; gt - W_LL gt] via the complementary (L-side) weights
    nb_is_l = (neighbors >= cap_pl) & valid[neighbors] & valid[:, None]
    W_l = torch.where(nb_is_l, Wmat, torch.zeros_like(Wmat))
    gt_at_nb = gt_info[torch.clamp(neighbors - cap_pl, 0, cap_l - 1)]
    w_gt = (W_l * gt_at_nb).sum(-1)
    b = torch.cat([w_gt[:cap_pl], gt_info - w_gt[cap_pl:]])
    # padded top rows: the A row is the identity there (W = 0): pin to x0
    x0 = x_info[:cap_pl]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    b = torch.cat([torch.where(valid_pl, b[:cap_pl], x0),
                   torch.where(valid_l, b[cap_pl:], zero)])

    rhs = AT_mv(b)
    x_new, iters = cg(lambda x: AT_mv(A_mv(x)), rhs, x0, tol=recon_tol,
                      maxiter=maxiter)

    # paste: corrected PL depths, then the exact LiDAR wherever gt > 0.
    # As in the JAX package, the padded entries (index HW, clipped to
    # HW - 1) paste 0 into the last pixel whenever n_pl < cap_pl.
    out = pred_flat.clone()
    out[torch.clamp(idx_pl, 0, HW - 1)] = torch.where(
        valid_pl, x_new, take(pred_flat, idx_pl))
    out = torch.where(gt_flat > 0, gt_flat, out).reshape(H, W)
    if return_info:
        return out, {"n_pl": int(n_pl_actual), "n_l": int(n_l_actual),
                     "overflow": bool((n_pl_actual > cap_pl)
                                      | (n_l_actual > cap_l)),
                     "cg_iters": iters}
    return out
