"""Sparse voxel 3-D refinement nets (counterpart of
`fusiondepth_tpu/models/refine_net3d.py`; the MinkowskiEngine RefineNet
family of reference networks/refine_net.py:13-270, which the flags
--refine_shallow, --refineUnet and --refine_deep select).

No sparse-tensor engine: the pseudo-3D point cloud of a depth map is
quantised into a fixed-capacity list of unique voxels (sort and segment
sums, every shape static), a sparse 3x3x3 convolution is a gather of each
voxel's 27 neighbours (a binary search over the sorted voxel keys)
followed by one matrix product (V, 27 C_in) x (27 C_in, C_out), and the
per-voxel output scatters back to the image through each pixel's voxel
index.

Exactly the JAX package's semantics:
- keys are int32, (2 * 512)^3 = 2^30 of them; a sort is stable, as
  jnp.argsort is; a neighbour lookup searches from the left and tests
  the clipped position for a hit;
- an empty slot of a voxel list takes the coordinates of the last
  sorted point and the key `_KEY_INVALID`; more unique voxels than
  `capacity` merge into the last slot (every slot then valid);
- segment sums run over each segment in source order, through a stable
  sort and `torch.segment_reduce`: the order of JAX's scatter-add on a
  CPU, and on a card the same sums on every run (no atomics);
- no host sync: `jnp.nonzero(size=...)` is built by a scatter of each
  segment's first position.

The nets take their input width at construction (flax infers it at
init). A SparseConv3D kernel keeps the flax layout (27 C_in, C_out): row
k C_in + c is input channel c at offset k of `_kernel_offsets`, so the
weights carry over unchanged (`models/jax_weights.py`). A VoxelBatchNorm's
running statistics are parameters: the JAX Refiner3D hands its whole
variable tree, batch_stats included, to optax.adam, and its nets run
with train=False, so the statistics take gradients and Adam steps.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from fusiondepth_torch.models.initializers import he_normal_
from fusiondepth_torch.ops.geometry import backproject_depth

# voxel coordinates are offset into [0, 2R) per axis, so the packed key
# stays within int32: (2R)^3 = 2^30 < 2^31
_COORD_RANGE = 512
_KEY_INVALID = 2 ** 31 - 1

# a voxel's input features: the mean depth of its points and occupancy 1
VOXEL_FEATURES = 2


def _encode(coords: torch.Tensor) -> torch.Tensor:
    """(N, 3) integer voxel coordinates -> sortable int32 keys."""
    c = coords.to(torch.int32) + _COORD_RANGE
    R = 2 * _COORD_RANGE
    return (c[:, 0] * R + c[:, 1]) * R + c[:, 2]


def segment_sum(data: torch.Tensor, seg: torch.Tensor, num_segments: int,
                is_sorted: bool = False) -> torch.Tensor:
    """jax.ops.segment_sum for segment ids in [0, num_segments]: each
    segment summed in source order from 0, an empty one 0; entries of id
    num_segments are dropped (they sort last, past every segment).
    `is_sorted` says that `seg` is non-decreasing already."""
    if not is_sorted:
        order = torch.argsort(seg, stable=True)
        data, seg = data[order], seg[order]
    bounds = torch.searchsorted(seg, torch.arange(
        num_segments + 1, dtype=seg.dtype, device=seg.device))
    return torch.segment_reduce(data, "sum", lengths=bounds[1:] - bounds[:-1],
                                axis=0, unsafe=True)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.rows = x.shape[0]
        hit = (idx >= 0).reshape(idx.shape + (1,) * (x.dim() - 1))
        return torch.where(hit, x[torch.clamp(idx, min=0)], 0.0)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        V, flat = ctx.rows, idx.reshape(-1).long()
        seg = torch.where(flat >= 0, flat, V)
        rows = segment_sum(g.reshape(flat.shape[0], -1), seg, V)
        return rows.reshape((V,) + g.shape[idx.dim():]), None


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] along x's first axis, 0 where idx < 0. Its backward sums
    each row's cotangents with `segment_sum` (a fixed order, no atomics):
    advanced indexing's backward accumulates the duplicates of an index
    one after another, and a sparse conv's missing neighbours (clipped to
    row 0) or a merged voxel's pixels repeat one index ~10^5 times: 35 ms
    a call on average, 2 s a b4 U-Net step at 640x192 on an H100."""
    return _GatherRows.apply(x, idx)


def _first_positions(is_first: torch.Tensor, capacity: int) -> torch.Tensor:
    """jnp.nonzero(is_first, size=capacity, fill_value=N - 1)[0]: the
    positions of the first `capacity` True entries, then N - 1."""
    N = is_first.shape[0]
    rank = torch.cumsum(is_first, 0) - 1
    slot = torch.where(is_first & (rank < capacity), rank, capacity)
    out = torch.full((capacity + 1,), N - 1, dtype=torch.long,
                     device=is_first.device)
    out.scatter_(0, slot, torch.arange(N, device=is_first.device))
    return out[:capacity]


def _unique_sorted(keys: torch.Tensor, capacity: int):
    """The fixed-capacity unique list of `keys`: (order, sorted keys,
    is_first, first positions, each sorted entry's slot)."""
    order = torch.argsort(keys, stable=True)
    sk = keys[order]
    is_first = torch.ones_like(sk, dtype=torch.bool)
    is_first[1:] = sk[1:] != sk[:-1]
    first_pos = _first_positions(is_first, capacity)
    seg = torch.clamp(torch.cumsum(is_first, 0) - 1, max=capacity - 1)
    return order, sk, is_first, first_pos, seg


def _inverse_scatter(order: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """zeros(N).at[order].set(seg) as int32."""
    return torch.zeros(order.shape[0], dtype=torch.int32,
                       device=order.device).scatter_(0, order,
                                                     seg.to(torch.int32))


def voxelize(points: torch.Tensor, values: torch.Tensor, voxel_size: float,
             capacity: int):
    """Quantise a point cloud into a fixed-capacity unique voxel list.

    points (N, 3) float, values (N, C). Returns (voxel coords (V, 3) int32,
    voxel features (V, C) mean-pooled, valid (V,), point_to_voxel (N,)
    int32, voxel keys (V,) int32 sorted)."""
    N = points.shape[0]
    R = _COORD_RANGE
    # clipped before the cast (XLA's conversion saturates; torch's would
    # wrap far outside the range)
    coords = torch.clamp(torch.floor(points / voxel_size), -R + 1,
                         R - 1).to(torch.int32)
    keys = _encode(coords)
    order, sk, is_first, first_pos, seg = _unique_sorted(keys, capacity)
    valid = torch.arange(capacity, device=points.device) < is_first.sum()
    vox_keys = torch.where(valid, sk[first_pos], _KEY_INVALID)
    vox_coords = coords[order][first_pos]
    sums = segment_sum(values[order], seg, capacity, is_sorted=True)
    cnts = segment_sum(torch.ones((N, 1), dtype=values.dtype,
                                  device=values.device), seg, capacity,
                       is_sorted=True)
    vox_feats = sums / torch.clamp(cnts, min=1.0)
    return vox_coords, vox_feats, valid, _inverse_scatter(order, seg), \
        vox_keys


def neighbor_table(vox_coords: torch.Tensor, vox_keys: torch.Tensor,
                   valid: torch.Tensor,
                   offsets: Sequence[Tuple[int, int, int]]) -> torch.Tensor:
    """(V, K) int32 neighbour indices into the voxel list (-1: missing).
    vox_keys must be the sorted keys `voxelize` gives."""
    V = vox_coords.shape[0]
    off = torch.tensor(offsets, dtype=torch.int32, device=vox_coords.device)
    q = _encode((vox_coords[:, None, :] + off[None]).reshape(-1, 3))
    q = torch.where(valid[:, None], q.reshape(V, -1), _KEY_INVALID - 1)
    pos = torch.clamp(torch.searchsorted(vox_keys, q), 0, V - 1)
    hit = vox_keys[pos] == q
    return torch.where(hit, pos, -1).to(torch.int32)


def _kernel_offsets(k: int = 3) -> List[Tuple[int, int, int]]:
    r = range(-(k // 2), k // 2 + 1)
    return [(a, b, c) for a in r for b in r for c in r]


class SparseConv3D(nn.Module):
    """3x3x3 sparse voxel convolution: gather, then one matrix product.
    `weight` is (K C_in, C_out), the flax kernel's layout."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        K = kernel ** 3
        self.weight = nn.Parameter(torch.empty(K * in_channels, features))
        self.bias = nn.Parameter(torch.zeros(features))
        he_normal_(self.weight, K * in_channels, generator)

    def forward(self, feats: torch.Tensor, neighbors: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
        V, C = feats.shape
        K = neighbors.shape[1]
        gathered = gather_rows(feats, neighbors)  # (V, K, C), 0 if missing
        out = gathered.reshape(V, K * C) @ self.weight + self.bias
        return torch.where(valid[:, None], out, 0.0)


class VoxelBatchNorm(nn.Module):
    """BatchNorm over the valid voxels only. Its running statistics are
    parameters (see the module docstring); train=True normalises with the
    batch's statistics and moves the running ones by 0.1 of them."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.running_mean = nn.Parameter(torch.zeros(channels))
        self.running_var = nn.Parameter(torch.ones(channels))

    def forward(self, feats: torch.Tensor, valid: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        if train:
            w = valid.to(feats.dtype)[:, None]
            n = torch.clamp(w.sum(), min=1.0)
            mean = (feats * w).sum(0) / n
            var = (((feats - mean) ** 2) * w).sum(0) / n
            with torch.no_grad():
                self.running_mean.copy_(0.9 * self.running_mean + 0.1 * mean)
                self.running_var.copy_(0.9 * self.running_var + 0.1 * var)
        else:
            mean, var = self.running_mean, self.running_var
        out = (feats - mean) * torch.rsqrt(var + 1e-5) * self.weight \
            + self.bias
        return torch.where(valid[:, None], out, 0.0)


class _SparseRefineStack(nn.Module):
    """N (conv, BN, ReLU) blocks, conv{i} and bn{i}, then the tanh offset
    head."""

    widths: Sequence[int] = ()

    def __init__(self, in_channels: int = VOXEL_FEATURES,
                 widths: Optional[Sequence[int]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.widths = tuple(widths or self.widths)
        c = in_channels
        for i, w in enumerate(self.widths):
            self.add_module(f"conv{i}", SparseConv3D(c, w,
                                                     generator=generator))
            self.add_module(f"bn{i}", VoxelBatchNorm(w))
            c = w
        self.head = SparseConv3D(c, 1, generator=generator)

    def forward(self, feats: torch.Tensor, neighbors: torch.Tensor,
                valid: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = feats
        for i in range(len(self.widths)):
            h = getattr(self, f"conv{i}")(h, neighbors, valid)
            h = torch.relu(getattr(self, f"bn{i}")(h, valid, train))
        return torch.tanh(self.head(h, neighbors, valid))


class RefineNet3DShallow(_SparseRefineStack):
    """3 sparse convs (reference RefineNet_shallow, refine_net.py:115-173)."""

    widths = (16, 32, 16)


class RefineNet3DDeep(_SparseRefineStack):
    """6 sparse convs (reference RefineNet_deep, refine_net.py:176-270)."""

    widths = (16, 32, 64, 64, 32, 16)


def voxel_downsample(coords: torch.Tensor, keys: torch.Tensor,
                     valid: torch.Tensor, feats: torch.Tensor,
                     capacity: int):
    """Pool child voxels into parents at coords // 2 (mean features).
    The padded children all share `_KEY_INVALID` and collapse into one
    parent slot, marked invalid. Returns (pcoords, pkeys, pvalid, pfeats,
    child_to_parent)."""
    pc = torch.div(coords, 2, rounding_mode="floor")
    pk = torch.where(valid, _encode(pc), _KEY_INVALID)
    order, sk, is_first, first_pos, seg = _unique_sorted(pk, capacity)
    first_keys = sk[first_pos]
    pvalid = (torch.arange(capacity, device=coords.device)
              < is_first.sum()) & (first_keys != _KEY_INVALID)
    pkeys = torch.where(pvalid, first_keys, _KEY_INVALID)
    pcoords = pc[order][first_pos]
    sums = segment_sum(feats[order], seg, capacity, is_sorted=True)
    w = valid[order].to(feats.dtype)[:, None]
    cnts = segment_sum(w, seg, capacity, is_sorted=True)
    pfeats = torch.where(pvalid[:, None], sums / torch.clamp(cnts, min=1.0),
                         0.0)
    return pcoords, pkeys, pvalid, pfeats, _inverse_scatter(order, seg)


def build_voxel_pyramid(coords: torch.Tensor, keys: torch.Tensor,
                        valid: torch.Tensor, levels: int, capacity: int):
    """Per-level tables for the U-Net ({"coords", "keys", "valid", "nb"})
    and the child-to-parent maps; each level's capacity is half the one
    below, at least 256."""
    offsets = _kernel_offsets(3)
    tables = [{"coords": coords, "keys": keys, "valid": valid,
               "nb": neighbor_table(coords, keys, valid, offsets)}]
    c2p = []
    cap = capacity
    for _ in range(levels):
        cap = max(cap // 2, 256)
        placeholder = torch.zeros((coords.shape[0], 1), device=coords.device)
        coords, keys, valid, _, map_ = voxel_downsample(
            coords, keys, valid, placeholder, cap)
        c2p.append(map_)
        tables.append({"coords": coords, "keys": keys, "valid": valid,
                       "nb": neighbor_table(coords, keys, valid, offsets)})
    return tables, c2p


def _pool_feats(feats: torch.Tensor, valid: torch.Tensor, c2p: torch.Tensor,
                capacity: int) -> torch.Tensor:
    """Mean-pool child features into parent slots through a child-to-parent
    map."""
    w = valid.to(feats.dtype)[:, None]
    sums = segment_sum(feats * w, c2p, capacity)
    cnts = segment_sum(w, c2p, capacity)
    return sums / torch.clamp(cnts, min=1.0)


class RefineNet3DUNet(nn.Module):
    """Sparse voxel U-Net: `len(widths) - 1` down stages (pool into the
    parent voxels, then conv), mirrored up stages (gather the parent's
    features back to the children, concatenate the skip, conv), and the
    tanh offset head (reference RefineNet, refine_net.py:13-112). Modules
    enc{l}_conv, enc{l}_bn, dec{l}_conv, dec{l}_bn and head, as in flax."""

    def __init__(self, in_channels: int = VOXEL_FEATURES,
                 widths: Sequence[int] = (16, 32, 64, 128, 256),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.widths = tuple(widths)
        L = len(self.widths) - 1
        c = in_channels
        for lvl, w in enumerate(self.widths):
            self.add_module(f"enc{lvl}_conv", SparseConv3D(
                c, w, generator=generator))
            self.add_module(f"enc{lvl}_bn", VoxelBatchNorm(w))
            c = w
        for lvl in range(L - 1, -1, -1):
            w = self.widths[lvl]
            self.add_module(f"dec{lvl}_conv", SparseConv3D(
                c + w, w, generator=generator))
            self.add_module(f"dec{lvl}_bn", VoxelBatchNorm(w))
            c = w
        self.head = SparseConv3D(c, 1, generator=generator)

    def _block(self, x, nb, valid, name, train):
        x = getattr(self, f"{name}_conv")(x, nb, valid)
        return torch.relu(getattr(self, f"{name}_bn")(x, valid, train))

    def forward(self, feats: torch.Tensor, tables: List[Dict],
                c2p: List[torch.Tensor], train: bool = False) -> torch.Tensor:
        L = len(self.widths) - 1
        if len(tables) < L + 1 or len(c2p) < L:
            raise ValueError(f"{L + 1} voxel levels needed, got "
                             f"{len(tables)} tables and {len(c2p)} maps")
        h = self._block(feats, tables[0]["nb"], tables[0]["valid"], "enc0",
                        train)
        skips = [h]
        for lvl in range(1, L + 1):
            cap = tables[lvl]["coords"].shape[0]
            h = _pool_feats(h, tables[lvl - 1]["valid"], c2p[lvl - 1], cap)
            h = self._block(h, tables[lvl]["nb"], tables[lvl]["valid"],
                            f"enc{lvl}", train)
            if lvl < L:
                skips.append(h)
        for lvl in range(L - 1, -1, -1):
            h_child = gather_rows(h, torch.clamp(c2p[lvl], 0,
                                                 h.shape[0] - 1))
            h_child = torch.where(tables[lvl]["valid"][:, None], h_child, 0.0)
            h = torch.cat([h_child, skips[lvl]], dim=-1)
            h = self._block(h, tables[lvl]["nb"], tables[lvl]["valid"],
                            f"dec{lvl}", train)
        return torch.tanh(self.head(h, tables[0]["nb"], tables[0]["valid"]))


def depth_to_voxels(depth: torch.Tensor, inv_K: torch.Tensor,
                    voxel_size: float = 0.5, capacity: int = 16384):
    """(H, W) depth and (4, 4) inv_K -> `voxelize` of its back-projected
    points, each voxel's features (mean depth, occupancy 1)."""
    H, W = depth.shape
    pts = backproject_depth(depth[None], inv_K[None])[0].reshape(-1, 3)
    vals = torch.stack([depth.reshape(-1), torch.ones(
        H * W, dtype=depth.dtype, device=depth.device)], dim=1)
    return voxelize(pts, vals, voxel_size, capacity)


def refine_depth_with_net(net: nn.Module, depth: torch.Tensor,
                          inv_K: torch.Tensor, voxel_size: float = 0.5,
                          capacity: int = 16384,
                          offset_scale: float = 1.0) -> torch.Tensor:
    """Voxelize, run a stacked voxel net (Shallow or Deep), and gather its
    per-voxel offset back to an (H, W) image, times `offset_scale` (the
    dense gather of reference refine_net.py:96-111)."""
    H, W = depth.shape
    coords, feats, valid, p2v, keys = depth_to_voxels(depth, inv_K,
                                                      voxel_size, capacity)
    nb = neighbor_table(coords, keys, valid, _kernel_offsets(3))
    off = net(feats, nb, valid)
    return (gather_rows(off[:, 0], p2v) * offset_scale).reshape(H, W)
