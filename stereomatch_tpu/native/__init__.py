"""Native host-side runtime components (C++ via ctypes).

Currently: the 3DMST segment-forest builder (treebuild.cpp) — the graph /
tree-construction stage that the reference implements with Boost.Graph and
union-find on the CPU (src/Stereo3DMST.cpp:213-543, include/segment-graph.h).
The hot label-optimization loop runs on the device (ops/mst.py); this
builder runs once per frame on the host and emits the flat arrays it
consumes.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass

import numpy as np

_LIB = None


def _load():
    global _LIB
    if _LIB is None:
        from .build import build

        path = build(verbose=False)
        lib = ctypes.CDLL(path)
        lib.build_forest.restype = ctypes.c_int
        _LIB = lib
    return _LIB


@dataclass
class Forest:
    """Flat segment-forest arrays in segment-contiguous DFS (Euler) order.

    Node order is tree-major then segment-major DFS; a segment's Euler
    events occupy a contiguous range of [0, 2N), so global prefix sums act
    segment-locally. `parent_node` of a segment root points at the node
    above the cut (tree roots point at themselves, w_exp=0); `rel_gd` is
    gamma * weighted depth within the segment (<= delta by construction).
    """

    height: int
    width: int
    pixel_of_node: np.ndarray  # (N,) int32
    parent_node: np.ndarray  # (N,) int32
    w_exp: np.ndarray  # (N,) float32, exp(-gamma * edge_w)
    rel_gd: np.ndarray  # (N,) float32
    in_pos: np.ndarray  # (N,) int32
    out_pos: np.ndarray  # (N,) int32
    seg_id: np.ndarray  # (N,) int32
    tree_id: np.ndarray  # (N,) int32
    node_of_pixel: np.ndarray  # (N,) int32
    tree_start: np.ndarray  # (T+1,) int32
    adj_start: np.ndarray  # (T+1,) int32 directed CSR over trees
    adj_list: np.ndarray  # (M,) int32
    num_trees: int
    num_segments: int

    @property
    def num_nodes(self) -> int:
        return self.height * self.width

    def seg_root_mask(self) -> np.ndarray:
        """First node of each segment. Nodes are segment-contiguous, so the
        roots are exactly the seg_id transitions (NOT rel_gd == 0: flat
        regions have zero-weight edges, hence zero depth everywhere)."""
        mask = np.empty(len(self.seg_id), bool)
        mask[0] = True
        mask[1:] = self.seg_id[1:] != self.seg_id[:-1]
        return mask


def build_forest(
    edge_w_right: np.ndarray,
    edge_w_down: np.ndarray,
    c: float,
    min_size: int,
    gamma: float,
    delta: float = 40.0,
) -> Forest:
    """Segment + build the MST forest from 4-neighbor edge weights.

    edge_w_right: (H, W-1) float32 weights between (y,x)-(y,x+1);
    edge_w_down: (H-1, W) between (y,x)-(y+1,x). See Forest for outputs.

    Falls back to the pure-Python builder (pyforest.py: Borůvka partition
    + numpy forest construction) when the native toolchain is unavailable.
    """
    try:
        lib = _load()
    except Exception as exc:  # no compiler / load failure
        import warnings

        from .pyforest import build_forest_fallback

        warnings.warn(
            f"native forest builder unavailable ({exc!r}); using the "
            "pure-Python Borůvka fallback (slower, statistically "
            "equivalent partition)",
            RuntimeWarning,
            stacklevel=2,
        )
        return build_forest_fallback(
            edge_w_right, edge_w_down, c, min_size, gamma, delta
        )
    h, wm1 = edge_w_right.shape
    hm1, w = edge_w_down.shape
    assert wm1 == w - 1 and hm1 == h - 1, (edge_w_right.shape, edge_w_down.shape)
    n = h * w
    wr = np.ascontiguousarray(edge_w_right, np.float32)
    wd = np.ascontiguousarray(edge_w_down, np.float32)

    i32 = lambda k: np.zeros(k, np.int32)  # noqa: E731
    f32 = lambda k: np.zeros(k, np.float32)  # noqa: E731
    pixel_of_node, parent_node = i32(n), i32(n)
    w_exp, rel_gd = f32(n), f32(n)
    in_pos, out_pos, seg_id, tree_id, node_of_pixel = (
        i32(n), i32(n), i32(n), i32(n), i32(n),
    )
    tree_start, adj_start = i32(n + 1), i32(n + 1)
    adj_cap = 4 * n + 16
    adj_list = i32(adj_cap)
    counts = i32(3)

    ptr_f = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))  # noqa: E731
    ptr_i = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))  # noqa: E731
    ret = lib.build_forest(
        ctypes.c_int(h),
        ctypes.c_int(w),
        ptr_f(wr),
        ptr_f(wd),
        ctypes.c_float(c),
        ctypes.c_int(min_size),
        ctypes.c_float(gamma),
        ctypes.c_float(delta),
        ptr_i(pixel_of_node),
        ptr_i(parent_node),
        ptr_f(w_exp),
        ptr_f(rel_gd),
        ptr_i(in_pos),
        ptr_i(out_pos),
        ptr_i(seg_id),
        ptr_i(tree_id),
        ptr_i(node_of_pixel),
        ptr_i(tree_start),
        ptr_i(adj_start),
        ptr_i(adj_list),
        ctypes.c_int64(adj_cap),
        ptr_i(counts),
    )
    if ret != 0:
        raise RuntimeError(f"build_forest failed with code {ret}")
    num_trees, num_segments, num_adj = map(int, counts)
    return Forest(
        height=h,
        width=w,
        pixel_of_node=pixel_of_node,
        parent_node=parent_node,
        w_exp=w_exp,
        rel_gd=rel_gd,
        in_pos=in_pos,
        out_pos=out_pos,
        seg_id=seg_id,
        tree_id=tree_id,
        node_of_pixel=node_of_pixel,
        tree_start=tree_start[: num_trees + 1],
        adj_start=adj_start[: num_trees + 1],
        adj_list=adj_list[:num_adj],
        num_trees=num_trees,
        num_segments=num_segments,
    )


def color_edge_weights(img: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """L1 color difference edge weights (reference diff(),
    src/Stereo3DMST.cpp:83-94) from an (H, W, C) or (H, W) image."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    wr = np.abs(img[:, 1:] - img[:, :-1]).sum(-1)
    wd = np.abs(img[1:, :] - img[:-1, :]).sum(-1)
    return wr, wd
