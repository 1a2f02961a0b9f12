"""FST serialization: OpenFst-compatible text and binary formats.

A jax-free copy of ``kaldi_decoder_tpu/fst/io.py`` (all of it, lines
19-411), kept because importing the original imports jax;
``tests/test_torch_fst_io.py`` holds the copy equal to the original, the
written bytes included.  One difference: :func:`read_fst` of a path
always parses through the port's host library (``kd_fst_open`` /
``kd_fst_fill``) and raises if it cannot be built; the original falls
back to the Python parser when its library is unavailable.  The Python
parser, ``_read_fst_body``, stays as a plain function (it reads file
objects), tested equal to the C++ one.

The formats: the OpenFst **text** format (``fstcompile``/``fstprint``
conventions) and the OpenFst **binary** ``VectorFst`` and ``ConstFst``
containers, for arc types ``standard`` (``fst::StdArc``) and ``lattice4``
(kaldifst's ``fst::LatticeArc``, a (graph, acoustic) float pair): magic
``0x7EB2FDD6``, length-prefixed type strings, little-endian, VectorFst
file version 2 (per state a final weight, an int64 arc count, then packed
arcs ``{int32 ilabel, int32 olabel, weight, int32 nextstate}``).
"""

from __future__ import annotations

import io as _io
import struct
from typing import Union

import numpy as np

from kaldi_decoder_tpu_torch import native
from kaldi_decoder_tpu_torch.fst.fst import INF, Lattice, StdVectorFst, VectorFst

FST_MAGIC = 2125659606  # OpenFst header magic number
_VECTOR_FST_TYPE = b"vector"
_FILE_VERSION = 2

_ARC_TYPES = {
    "standard": b"standard",
    "lattice": b"lattice4",
}
_ARC_TYPES_REV = {v: k for k, v in _ARC_TYPES.items()}


# ---------------------------------------------------------------------------
# Binary format
# ---------------------------------------------------------------------------


def _write_string(f, s: bytes) -> None:
    f.write(struct.pack("<i", len(s)))
    f.write(s)


def _read_string(f) -> bytes:
    (n,) = struct.unpack("<i", f.read(4))
    return f.read(n)


def write_fst(fst: VectorFst, path_or_file) -> None:
    """Write an FST in OpenFst binary VectorFst format."""
    if hasattr(path_or_file, "write"):
        _write_fst_body(fst, path_or_file)
    else:
        with open(path_or_file, "wb") as f:
            _write_fst_body(fst, f)


def _write_fst_body(fst: VectorFst, f) -> None:
    arrays = fst.to_arrays()
    S = fst.num_states
    E = int(arrays["row_ptr"][-1])
    f.write(struct.pack("<i", FST_MAGIC))
    _write_string(f, _VECTOR_FST_TYPE)
    _write_string(f, _ARC_TYPES[fst.arc_type])
    f.write(struct.pack("<i", _FILE_VERSION))
    f.write(struct.pack("<i", 0))  # flags
    f.write(struct.pack("<Q", 0))  # properties (unknown)
    f.write(struct.pack("<q", fst.start))
    f.write(struct.pack("<q", S))
    f.write(struct.pack("<q", E))

    wd = fst._weight_dim
    row_ptr = arrays["row_ptr"]
    il, ol, ns = arrays["ilabel"], arrays["olabel"], arrays["nextstate"]
    w = arrays["weight"]
    final = arrays["final"]
    for s in range(S):
        if wd == 1:
            f.write(struct.pack("<f", final[s]))
        else:
            f.write(struct.pack("<ff", final[s][0], final[s][1]))
        lo, hi = int(row_ptr[s]), int(row_ptr[s + 1])
        f.write(struct.pack("<q", hi - lo))
        for a in range(lo, hi):
            if wd == 1:
                f.write(
                    struct.pack("<iifi", il[a], ol[a], w[a], ns[a])
                )
            else:
                f.write(
                    struct.pack("<iiffi", il[a], ol[a], w[a][0], w[a][1], ns[a])
                )


def read_fst(path_or_file) -> Union[StdVectorFst, Lattice]:
    """Read an OpenFst binary VectorFst or ConstFst (arc type standard or
    lattice4).  A path is parsed by the host library; a file object by the
    Python parser."""
    if hasattr(path_or_file, "read"):
        return _read_fst_body(path_or_file)
    arr = native.read_fst_arrays(str(path_or_file))
    cls = StdVectorFst if arr["weight_dim"] == 1 else Lattice
    return cls.from_arrays(
        arr["row_ptr"], arr["ilabel"], arr["olabel"], arr["weight"],
        arr["nextstate"], arr["final"], arr["start"],
    )


def _read_fst_body(f):
    (magic,) = struct.unpack("<i", f.read(4))
    if magic != FST_MAGIC:
        raise ValueError(f"Bad FST magic {magic:#x} (not an OpenFst binary file)")
    fst_type = _read_string(f)
    arc_type_b = _read_string(f)
    if fst_type not in (b"vector", b"const"):
        raise ValueError(f"Unsupported FST container type {fst_type!r}")
    if arc_type_b not in _ARC_TYPES_REV:
        raise ValueError(f"Unsupported arc type {arc_type_b!r}")
    arc_type = _ARC_TYPES_REV[arc_type_b]
    (version,) = struct.unpack("<i", f.read(4))
    (_flags,) = struct.unpack("<i", f.read(4))
    (_props,) = struct.unpack("<Q", f.read(8))
    (start,) = struct.unpack("<q", f.read(8))
    (num_states,) = struct.unpack("<q", f.read(8))
    (_num_arcs,) = struct.unpack("<q", f.read(8))
    if fst_type == b"const":
        return _read_const_body(
            f, arc_type, version, start, num_states, _num_arcs
        )
    if version < 1 or version > _FILE_VERSION:
        raise ValueError(f"Unsupported VectorFst file version {version}")

    cls = StdVectorFst if arc_type == "standard" else Lattice
    fst = cls()
    if num_states < 0:
        num_states = 0
    fst.add_states(int(num_states))
    wd = cls._weight_dim
    # Bulk-read the remainder and parse with a moving offset — much faster
    # than struct-by-struct for million-arc graphs.
    buf = f.read()
    off = 0
    arc_fmt_size = 16 if wd == 1 else 20
    for s in range(int(num_states)):
        if wd == 1:
            (fw,) = struct.unpack_from("<f", buf, off)
            off += 4
            if fw != INF:
                fst.set_final(s, float(fw))
        else:
            g, a = struct.unpack_from("<ff", buf, off)
            off += 8
            if g != INF or a != INF:
                fst.set_final(s, (float(g), float(a)))
        (narcs,) = struct.unpack_from("<q", buf, off)
        off += 8
        if narcs:
            raw = np.frombuffer(
                buf, dtype=np.uint8, count=narcs * arc_fmt_size, offset=off
            ).reshape(narcs, arc_fmt_size)
            off += narcs * arc_fmt_size
            il = raw[:, 0:4].copy().view("<i4").ravel()
            ol = raw[:, 4:8].copy().view("<i4").ravel()
            sa = fst._arcs[s]
            sa.ilabels = il.tolist()
            sa.olabels = ol.tolist()
            if wd == 1:
                w = raw[:, 8:12].copy().view("<f4").ravel()
                ns = raw[:, 12:16].copy().view("<i4").ravel()
                sa.weights = [float(x) for x in w]
            else:
                g = raw[:, 8:12].copy().view("<f4").ravel()
                ac = raw[:, 12:16].copy().view("<f4").ravel()
                ns = raw[:, 16:20].copy().view("<i4").ravel()
                sa.weights = list(zip((float(x) for x in g), (float(x) for x in ac)))
            sa.nextstates = ns.tolist()
    if start >= 0:
        fst.set_start(int(start))
    return fst


def _read_const_body(f, arc_type, version, start, num_states, num_arcs):
    """Parse the ConstFst<Arc, uint32> container (openfst const-fst.h).

    Layout after the header: a flat state table — per state
    ``{final weight(s), u32 pos, u32 narcs, u32 niepsilons, u32
    noepsilons}`` — then the packed arc array.  File version 1 aligns each
    array to 16 bytes from the file start; version 2 is unaligned.  Real
    icefall HLGs ship in this format, and the reference binds ConstFst
    constructors (`python/csrc/simple-decoder.cc:16-21`).
    """
    if version < 1 or version > 2:
        raise ValueError(f"Unsupported ConstFst file version {version}")
    cls = StdVectorFst if arc_type == "standard" else Lattice
    wd = cls._weight_dim
    if num_states < 0:
        num_states = 0
    if num_arcs < 0:
        num_arcs = 0
    # Header size: magic(4) + 2 length-prefixed strings + version(4) +
    # flags(4) + props(8) + start/nstates/narcs(24).
    hdr_len = 4 + (4 + len(b"const")) + (4 + _ARC_TYPES[arc_type].__len__())
    hdr_len += 4 + 4 + 8 + 24
    buf = f.read()
    off = 0

    def align16(off):
        pos = hdr_len + off
        return off + ((16 - (pos & 15)) & 15)

    if version == 1:
        off = align16(off)
    ss = 4 * wd + 16  # state record bytes
    raw = np.frombuffer(
        buf, np.uint8, count=num_states * ss, offset=off
    ).reshape(num_states, ss)
    off += num_states * ss
    finals = raw[:, : 4 * wd].copy().view("<f4").reshape(num_states, wd)
    pos_arr = raw[:, 4 * wd : 4 * wd + 4].copy().view("<u4").ravel()
    narcs_arr = raw[:, 4 * wd + 4 : 4 * wd + 8].copy().view("<u4").ravel()
    ends = pos_arr.astype(np.int64) + narcs_arr
    starts_expected = np.concatenate([[0], ends[:-1]])
    if num_states and (
        np.any(pos_arr != starts_expected) or (num_states and ends[-1] != num_arcs)
    ):
        raise ValueError("ConstFst state arc ranges not contiguous")
    row_ptr = np.concatenate([[0], ends]).astype(np.int64)

    if version == 1:
        off = align16(off)
    ab = 12 + 4 * wd  # arc record bytes
    araw = np.frombuffer(
        buf, np.uint8, count=num_arcs * ab, offset=off
    ).reshape(num_arcs, ab)
    il = araw[:, 0:4].copy().view("<i4").ravel()
    ol = araw[:, 4:8].copy().view("<i4").ravel()
    w = araw[:, 8 : 8 + 4 * wd].copy().view("<f4").reshape(num_arcs, wd)
    ns = araw[:, 8 + 4 * wd :].copy().view("<i4").ravel()
    if wd == 1:
        w = w.ravel()
        finals = finals.ravel()
    return cls.from_arrays(row_ptr, il, ol, w, ns, finals, int(start))


def write_const_fst(fst: VectorFst, path_or_file) -> None:
    """Write in OpenFst binary ConstFst<Arc, uint32> format (version 2,
    unaligned) — the format icefall HLGs commonly ship in."""
    if hasattr(path_or_file, "write"):
        _write_const_body(fst, path_or_file)
    else:
        with open(path_or_file, "wb") as f:
            _write_const_body(fst, f)


def _write_const_body(fst: VectorFst, f) -> None:
    arrays = fst.to_arrays()
    S = fst.num_states
    row_ptr = np.asarray(arrays["row_ptr"], np.int64)
    E = int(row_ptr[-1])
    wd = fst._weight_dim
    f.write(struct.pack("<i", FST_MAGIC))
    _write_string(f, b"const")
    _write_string(f, _ARC_TYPES[fst.arc_type])
    f.write(struct.pack("<i", 2))  # ConstFst file version (unaligned)
    f.write(struct.pack("<i", 0))  # flags
    f.write(struct.pack("<Q", 0x1))  # properties: kExpanded
    f.write(struct.pack("<q", fst.start))
    f.write(struct.pack("<q", S))
    f.write(struct.pack("<q", E))
    il = np.asarray(arrays["ilabel"], np.int32)
    ol = np.asarray(arrays["olabel"], np.int32)
    ns = np.asarray(arrays["nextstate"], np.int32)
    w = np.asarray(arrays["weight"], np.float32).reshape(E, wd)
    fin = np.asarray(arrays["final"], np.float32).reshape(S, wd)
    narcs = np.diff(row_ptr).astype(np.uint32)
    nieps = np.zeros(S, np.uint32)
    noeps = np.zeros(S, np.uint32)
    for s in range(S):
        lo, hi = int(row_ptr[s]), int(row_ptr[s + 1])
        nieps[s] = int(np.sum(il[lo:hi] == 0))
        noeps[s] = int(np.sum(ol[lo:hi] == 0))
    st = np.zeros((S, 4 * wd + 16), np.uint8)
    st[:, : 4 * wd] = fin.view("<u1").reshape(S, 4 * wd)
    st[:, 4 * wd : 4 * wd + 4] = (
        row_ptr[:-1].astype("<u4").view("<u1").reshape(S, 4)
    )
    st[:, 4 * wd + 4 : 4 * wd + 8] = narcs.view("<u1").reshape(S, 4)
    st[:, 4 * wd + 8 : 4 * wd + 12] = nieps.view("<u1").reshape(S, 4)
    st[:, 4 * wd + 12 :] = noeps.view("<u1").reshape(S, 4)
    f.write(st.tobytes())
    ar = np.zeros((E, 12 + 4 * wd), np.uint8)
    ar[:, 0:4] = il.view("<u1").reshape(E, 4)
    ar[:, 4:8] = ol.view("<u1").reshape(E, 4)
    ar[:, 8 : 8 + 4 * wd] = w.view("<u1").reshape(E, 4 * wd)
    ar[:, 8 + 4 * wd :] = ns.view("<u1").reshape(E, 4)
    f.write(ar.tobytes())


# ---------------------------------------------------------------------------
# Text format
# ---------------------------------------------------------------------------


def _format_weight(w, wd: int) -> str:
    # .9g: enough digits to roundtrip float32 exactly (OpenFst prints
    # weights with high precision too).
    if wd == 1:
        return f"{w:.9g}"
    return f"{w[0]:.9g},{w[1]:.9g}"


def _parse_weight(tok: str, wd: int):
    if wd == 1:
        return float(tok)
    parts = tok.split(",")
    return (float(parts[0]), float(parts[1]))


def fst_to_text(fst: VectorFst) -> str:
    """Serialize in OpenFst text format (``fstprint`` style, integer labels).

    Arc lines: ``src dst ilabel olabel [weight]``; final lines:
    ``state [weight]``.  The start state's lines come first, as OpenFst
    requires (first mentioned src is the start state).
    """
    wd = fst._weight_dim
    out = _io.StringIO()
    order = list(range(fst.num_states))
    if fst.start >= 0:
        order.remove(fst.start)
        order.insert(0, fst.start)
    one = fst.weight_one()
    for s in order:
        for arc in fst.arcs(s):
            if arc.weight == one:
                out.write(f"{s}\t{arc.nextstate}\t{arc.ilabel}\t{arc.olabel}\n")
            else:
                out.write(
                    f"{s}\t{arc.nextstate}\t{arc.ilabel}\t{arc.olabel}\t"
                    f"{_format_weight(arc.weight, wd)}\n"
                )
        if fst.is_final(s):
            fw = fst.final(s)
            if fw == one:
                out.write(f"{s}\n")
            else:
                out.write(f"{s}\t{_format_weight(fw, wd)}\n")
    return out.getvalue()


def fst_from_text(text: str, arc_type: str = "standard") -> Union[StdVectorFst, Lattice]:
    """Parse OpenFst text format.  Numeric state ids are used as-is (states
    are created up to the max id), and the first-mentioned source state is
    the start state — ``fstcompile`` semantics."""
    cls = StdVectorFst if arc_type == "standard" else Lattice
    wd = cls._weight_dim
    fst = cls()

    def sid(tok: str) -> int:
        s = int(tok)
        while fst.num_states <= s:
            fst.add_state()
        return s

    start_set = False
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) in (1, 2):
            s = sid(parts[0])
            w = _parse_weight(parts[1], wd) if len(parts) == 2 else cls.weight_one()
            fst.set_final(s, w)
            if not start_set:
                fst.set_start(s)
                start_set = True
        elif len(parts) in (4, 5):
            s = sid(parts[0])
            d = sid(parts[1])
            w = _parse_weight(parts[4], wd) if len(parts) == 5 else cls.weight_one()
            fst.add_arc(s, int(parts[2]), int(parts[3]), w, d)
            if not start_set:
                fst.set_start(s)
                start_set = True
        else:
            raise ValueError(f"Bad FST text line: {line!r}")
    return fst


def read_fst_text(path, arc_type: str = "standard"):
    with open(path, "r") as f:
        return fst_from_text(f.read(), arc_type)


def write_fst_text(fst: VectorFst, path) -> None:
    with open(path, "w") as f:
        f.write(fst_to_text(fst))
