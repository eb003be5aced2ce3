"""Dataset IO: the reference's on-disk binary formats + text converters.

Formats (all little-endian, from /root/reference/inputs):
  graph.bsnap    — header {int32 sizeOfVertexType(=4), uint32 numVertices,
                   pad to 8, uint64 numEdges} then (src,dst) uint32 pairs
                   (graphToBinary.cpp:15-19,76,94-99)
  features.bsnap — header {uint32 numFeatures} then float32 row-major
                   (featuresToBinary.cpp:20-23,44-64)
  labels.bsnap   — header {uint32 labelKinds} then uint32 per vertex
                   (labelsToBinary.cpp:18-21,44-57)
  *.parts        — text, one partition id per line (METIS output consumed
                   by the reference's DataLoader::readPartsFile)

The reference's per-node preprocessed cache (graph.<id>.bin,
graph.cpp:7-115) is not reproduced byte-for-byte: partitioning here
produces padded device shards directly (graph/partition.py). Loading the
*source* formats means every dataset prepared for the reference loads
unchanged.
"""

from __future__ import annotations

import re
import struct
from pathlib import Path
from typing import Optional

import numpy as np

from dorylus_tpu.graph.graph import Graph

# C struct {int; unsigned; unsigned long long} on LP64: uint64 lands at
# offset 8 (already aligned), so sizeof == 16 with no padding.
_GRAPH_HDR = struct.Struct("<iIQ")  # sizeOfVertexType, numVertices, numEdges


def write_graph_bsnap(path: str | Path, src: np.ndarray, dst: np.ndarray,
                      num_vertices: int) -> None:
    with open(path, "wb") as f:
        f.write(_GRAPH_HDR.pack(4, num_vertices, len(src)))
        pairs = np.empty((len(src), 2), dtype="<u4")
        pairs[:, 0] = src
        pairs[:, 1] = dst
        f.write(pairs.tobytes())


def read_graph_bsnap(path: str | Path) -> tuple[np.ndarray, np.ndarray, int]:
    """Returns (src, dst, num_vertices). The edge payload is memory-mapped
    (one streaming copy into the int32 outputs), never buffered whole —
    Friendster-scale bsnap files are tens of GB."""
    with open(path, "rb") as f:
        size_of_vtx, num_v, num_e = _GRAPH_HDR.unpack(f.read(_GRAPH_HDR.size))
    assert size_of_vtx == 4, f"unsupported vertex width {size_of_vtx}"
    # The uint32 format allows ids the int32 pipeline cannot represent;
    # a silent wrap to negative would corrupt the native counting sorts
    # downstream (same guard as the text parser, round-5 review).
    if num_v >= 2**31:
        raise ValueError(
            f"{path}: num_vertices {num_v} exceeds the int32 vertex-id "
            "range this pipeline uses")
    pairs = np.memmap(path, dtype="<u4", mode="r", offset=_GRAPH_HDR.size,
                      shape=(num_e, 2))
    src = pairs[:, 0].astype(np.int32)
    dst = pairs[:, 1].astype(np.int32)
    if len(src) and (int(pairs.max()) >= num_v or src.min() < 0
                     or dst.min() < 0):
        raise ValueError(
            f"{path}: edge endpoint ids out of range [0, {num_v})")
    return src, dst, int(num_v)


def write_features_bsnap(path: str | Path, feats: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<I", feats.shape[1]))
        f.write(np.ascontiguousarray(feats, dtype="<f4").tobytes())


def read_features_bsnap(path: str | Path, feature_dim: Optional[int] = None
                        ) -> np.ndarray:
    with open(path, "rb") as f:
        (hdr_dim,) = struct.unpack("<I", f.read(4))
    dim = hdr_dim or feature_dim
    assert dim, "feature dim not in header; pass feature_dim"
    flat = np.memmap(path, dtype="<f4", mode="r", offset=4)
    assert flat.size % dim == 0, (flat.size, dim)
    return np.asarray(flat, np.float32).reshape(-1, dim)


def write_labels_bsnap(path: str | Path, labels: np.ndarray,
                       label_kinds: int) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<I", label_kinds))
        f.write(np.ascontiguousarray(labels, dtype="<u4").tobytes())


def read_labels_bsnap(path: str | Path) -> tuple[np.ndarray, int]:
    with open(path, "rb") as f:
        (kinds,) = struct.unpack("<I", f.read(4))
    labels = np.memmap(path, dtype="<u4", mode="r",
                       offset=4).astype(np.int32)
    return labels, int(kinds)


def read_parts_file(path: str | Path) -> np.ndarray:
    """METIS-style parts file: one partition id per line."""
    return np.loadtxt(path, dtype=np.int32).reshape(-1)


def write_parts_file(path: str | Path, parts: np.ndarray) -> None:
    np.savetxt(path, parts.reshape(-1, 1), fmt="%d")


def read_text_edges(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """Text snap edge list (skip '#'/'%' comments, drop self loops) —
    graphToBinary.cpp:readFile semantics. Dispatches to the native
    parallel parser (native/graphcore.cpp gc_parse_edges, ~memory
    bandwidth) with this module's line loop as the fallback."""
    from dorylus_tpu import native
    return native.parse_edges(path)


_EDGE_LINE = re.compile(r"^[ \t\r]*(\d+)[ \t\r]+(\d+)")


def _read_text_edges_py(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """Line rule — IDENTICAL to gc_parse_edges (tests/test_parse_edges.py
    pins the equivalence on adversarial lines): an edge line is a leading
    digit run, whitespace, a second digit run; anything after the second
    run is ignored ('1 2.5' -> (1, 2)); lines with negatives, a
    non-digit suffix on the FIRST token ('12x 5'), or ids >= 2^31 are
    dropped (a wrapped id would corrupt downstream counting sorts);
    '#'/'%' comments and self loops are dropped."""
    srcs, dsts = [], []
    with open(path) as f:
        for line in f:
            m = _EDGE_LINE.match(line)
            if not m:
                continue
            s, d = int(m.group(1)), int(m.group(2))
            if s == d or s >= 2**31 or d >= 2**31:
                continue
            srcs.append(s)
            dsts.append(d)
    return np.asarray(srcs, np.int32), np.asarray(dsts, np.int32)


def features_to_text(bsnap_path: str | Path, out_path: str | Path,
                     feature_dim: Optional[int] = None) -> None:
    """Binary features back to text — miscs/check-correctness/
    feat-bsnap-to-text.py analog."""
    feats = read_features_bsnap(bsnap_path, feature_dim)
    np.savetxt(out_path, feats, fmt="%.6f")


def load_dataset(data_dir: str | Path, undirected: bool = True,
                 feature_dim: Optional[int] = None) -> Graph:
    """Load a reference-format dataset directory:
    graph.bsnap + features.bsnap + labels.bsnap (the layout inputs/prepare
    produces and gnnman/send-dataset ships to each node)."""
    d = Path(data_dir)
    src, dst, num_v = read_graph_bsnap(d / "graph.bsnap")
    feats = read_features_bsnap(d / "features.bsnap", feature_dim)
    labels, kinds = read_labels_bsnap(d / "labels.bsnap")
    assert feats.shape[0] >= num_v, (feats.shape, num_v)
    if undirected:
        src, dst = Graph.make_undirected(src, dst)
    g = Graph(num_vertices=num_v, src=src, dst=dst,
              features=feats[:num_v], labels=labels[:num_v], num_classes=kinds)
    return g.finalize()


def save_dataset(data_dir: str | Path, g: Graph) -> None:
    d = Path(data_dir)
    d.mkdir(parents=True, exist_ok=True)
    write_graph_bsnap(d / "graph.bsnap", g.src, g.dst, g.num_vertices)
    write_features_bsnap(d / "features.bsnap", g.features)
    write_labels_bsnap(d / "labels.bsnap", g.labels, g.num_classes)


def prepare_from_text(edge_file: str | Path, features_file: str | Path,
                      labels_file: str | Path, out_dir: str | Path,
                      feature_dim: int, label_kinds: int,
                      undirected: bool = True) -> Graph:
    """The inputs/prepare pipeline: text -> binary dataset dir."""
    src, dst = read_text_edges(edge_file)
    if len(src) == 0:
        raise ValueError(
            f"no edges parsed from {edge_file} — every line was a "
            "comment, a self loop, or malformed (see the parser's drop "
            "rules in _read_text_edges_py)")
    num_v = int(max(src.max(), dst.max())) + 1
    feats = np.loadtxt(features_file, dtype=np.float32, delimiter=None)
    feats = feats.reshape(-1, feature_dim)
    labels = np.loadtxt(labels_file, dtype=np.int64).astype(np.int32).reshape(-1)
    # Coverage validation at PREPARE time — load_dataset asserts this on
    # read, but by then the corrupt dataset is already on disk.
    if feats.shape[0] < num_v or labels.shape[0] < num_v:
        raise ValueError(
            f"features/labels cover {feats.shape[0]}/{labels.shape[0]} "
            f"vertices but the edge list implies num_v={num_v}")
    g = Graph(num_vertices=num_v, src=src, dst=dst, features=feats[:num_v],
              labels=labels[:num_v], num_classes=label_kinds)
    if undirected:
        g.src, g.dst = Graph.make_undirected(g.src, g.dst)
    g.finalize()
    save_dataset(out_dir, g)
    return g
