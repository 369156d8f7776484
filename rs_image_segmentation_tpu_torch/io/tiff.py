"""Self-contained GeoTIFF codec (host side).

Counterpart of ``rs_image_segmentation_tpu.io.tiff``, the same code: the
port keeps its own copy so it never imports the JAX package, and a file
written by either package has the same bytes. Scenes are decoded on the
host into contiguous band-major ``(C, H, W)`` numpy buffers, ready for a
copy to the card (tile streaming lives in ``io.stream``). The C++
strip/tile codec (``io.native``, built from ``native/tiffcodec.cpp``)
plugs in behind the same API when it builds; this pure-Python
implementation is the always-on fallback and the correctness oracle.

Capabilities:
  read  : classic TIFF and BigTIFF, strips or tiles, PlanarConfig 1/2,
          uint8/16/32, int8/16/32, float32/64, compression
          none/LZW/Deflate/PackBits, horizontal and floating-point
          predictors; geo transform (ModelPixelScale+Tiepoint or
          ModelTransformation), CRS (GeoKeyDirectory EPSG / citation),
          GDAL_NODATA, palette, band descriptions (GDAL_METADATA).
  write : uint8/16/int16/int32/float32/float64, contiguous or
          band-sequential, strips or 256x256 tiles, LZW (with horizontal
          predictor for ints), geo tags, palette, nodata, band
          descriptions; and :class:`TiffTileStreamWriter`, the tiled
          single-band writer fed row by row (the large-scene drivers'
          ``writer=``).
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.types import GeoMeta
from . import native as _native

# --- TIFF constants ---------------------------------------------------------

_TYPE_FMT = {1: "B", 2: "s", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h",
             9: "i", 10: "ii", 11: "f", 12: "d", 16: "Q", 17: "q"}
_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
              11: 4, 12: 8, 16: 8, 17: 8}

T_IMAGE_WIDTH = 256
T_IMAGE_LENGTH = 257
T_BITS_PER_SAMPLE = 258
T_COMPRESSION = 259
T_PHOTOMETRIC = 262
T_IMAGE_DESCRIPTION = 270
T_STRIP_OFFSETS = 273
T_SAMPLES_PER_PIXEL = 277
T_ROWS_PER_STRIP = 278
T_STRIP_BYTE_COUNTS = 279
T_PLANAR_CONFIG = 284
T_PREDICTOR = 317
T_COLORMAP = 320
T_TILE_WIDTH = 322
T_TILE_LENGTH = 323
T_TILE_OFFSETS = 324
T_TILE_BYTE_COUNTS = 325
T_EXTRA_SAMPLES = 338
T_SAMPLE_FORMAT = 339
T_MODEL_PIXEL_SCALE = 33550
T_MODEL_TIEPOINT = 33922
T_MODEL_TRANSFORMATION = 34264
T_GEO_KEY_DIRECTORY = 34735
T_GEO_DOUBLE_PARAMS = 34736
T_GEO_ASCII_PARAMS = 34737
T_GDAL_METADATA = 42112
T_GDAL_NODATA = 42113

COMP_NONE = 1
COMP_LZW = 5
COMP_DEFLATE_ADOBE = 8
COMP_DEFLATE = 32946
COMP_PACKBITS = 32773

SF_UINT = 1
SF_INT = 2
SF_FLOAT = 3


# --- LZW (TIFF variant: MSB-first bits, early code-size change) -------------

def lzw_decode(data: bytes, expected_size: Optional[int] = None) -> bytes:
    """Decode TIFF-flavor LZW (codes MSB-first, clear=256, eoi=257)."""
    if expected_size is not None and _native.available():
        decoded = _native.lzw_decode(data, expected_size)
        if decoded is not None:
            return decoded
    out = bytearray()
    table: List[bytes] = []

    def reset_table():
        nonlocal table
        table = [bytes([i]) for i in range(256)] + [b"", b""]

    reset_table()
    bitlen = 9
    buf = 0
    nbits = 0
    prev: Optional[bytes] = None
    pos = 0
    n = len(data)
    while pos < n or nbits >= bitlen:
        while nbits < bitlen and pos < n:
            buf = (buf << 8) | data[pos]
            pos += 1
            nbits += 8
        if nbits < bitlen:
            break
        code = (buf >> (nbits - bitlen)) & ((1 << bitlen) - 1)
        nbits -= bitlen
        if code == 256:  # clear
            reset_table()
            bitlen = 9
            prev = None
            continue
        if code == 257:  # end of information
            break
        if prev is None:
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        elif code == len(table):
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError("corrupt LZW stream")
        out += entry
        prev = entry
        # TIFF "early change": bump width when next code would not fit
        if len(table) + 1 >= (1 << bitlen) and bitlen < 12:
            bitlen += 1
        if expected_size is not None and len(out) >= expected_size:
            break
    return bytes(out)


def lzw_encode(data: bytes) -> bytes:
    """Encode TIFF-flavor LZW."""
    if _native.available():
        encoded = _native.lzw_encode(data)
        if encoded is not None:
            return encoded
    out = bytearray()
    buf = 0
    nbits = 0

    def emit(code: int, bitlen: int):
        nonlocal buf, nbits
        buf = (buf << bitlen) | code
        nbits += bitlen
        while nbits >= 8:
            out.append((buf >> (nbits - 8)) & 0xFF)
            nbits -= 8
        buf &= (1 << nbits) - 1

    table: Dict[bytes, int] = {bytes([i]): i for i in range(256)}
    next_code = 258
    bitlen = 9
    emit(256, bitlen)  # clear
    w = b""
    for b in data:
        wc = w + bytes([b])
        if wc in table:
            w = wc
        else:
            emit(table[w], bitlen)
            table[wc] = next_code
            next_code += 1
            # early change: width bump one code before the table fills
            if next_code + 1 > (1 << bitlen):
                if bitlen < 12:
                    bitlen += 1
                else:
                    emit(256, bitlen)
                    table = {bytes([i]): i for i in range(256)}
                    next_code = 258
                    bitlen = 9
            w = bytes([b])
    if w:
        emit(table[w], bitlen)
    emit(257, bitlen)  # EOI
    if nbits:
        out.append((buf << (8 - nbits)) & 0xFF)
    return bytes(out)


def packbits_decode(data: bytes, expected_size: Optional[int] = None) -> bytes:
    if expected_size is not None and _native.available():
        decoded = _native.packbits_decode(data, expected_size)
        if decoded is not None:
            return decoded
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        h = data[i]
        i += 1
        if h < 128:
            out += data[i:i + h + 1]
            i += h + 1
        elif h > 128:
            out += bytes([data[i]]) * (257 - h)
            i += 1
    return bytes(out)


# --- predictor ---------------------------------------------------------------

def _unpredict_horizontal(arr: np.ndarray) -> np.ndarray:
    """Undo horizontal differencing in place along the last (pixel) axis.
    arr shape: (rows, cols, samples)."""
    np.cumsum(arr, axis=1, dtype=arr.dtype, out=arr)
    return arr


def _predict_horizontal(arr: np.ndarray) -> np.ndarray:
    out = arr.copy()
    out[:, 1:, :] -= arr[:, :-1, :]
    return out


def _unpredict_float(raw: bytes, rows: int, cols: int, samples: int,
                     itemsize: int, byteorder: str) -> np.ndarray:
    """TIFF predictor 3 (floating-point): per row, bytes are differenced then
    split by byte plane (all MSBs first). Undo both."""
    row_bytes = cols * samples * itemsize
    data = np.frombuffer(raw, dtype=np.uint8).copy().reshape(rows, row_bytes)
    np.cumsum(data, axis=1, dtype=np.uint8, out=data)
    # de-interleave byte planes: plane p holds byte p (big-endian order)
    planes = data.reshape(rows, itemsize, cols * samples)
    out = np.empty((rows, cols * samples, itemsize), dtype=np.uint8)
    for p in range(itemsize):
        out[:, :, p] = planes[:, p, :]
    flat = out.reshape(rows, cols, samples, itemsize)
    # bytes are stored MSB-first regardless of file byte order
    dt = np.dtype({1: None, 2: np.float16, 4: np.float32, 8: np.float64}[itemsize])
    return flat.view(np.uint8).reshape(-1, itemsize)[:, ::-1].copy().view(
        dt.newbyteorder("<")).reshape(rows, cols, samples).astype(dt)


# --- reading -----------------------------------------------------------------

@dataclasses.dataclass
class TiffInfo:
    width: int
    height: int
    count: int
    dtype: np.dtype
    meta: GeoMeta
    band_names: Optional[Tuple[Optional[str], ...]] = None
    colormap: Optional[np.ndarray] = None  # (N, 3) uint16
    compression: int = COMP_NONE
    tiled: bool = False


class _Reader:
    """Classic and BigTIFF (version 43) IFD reader."""

    def __init__(self, data: bytes):
        self.data = data
        bo = data[:2]
        if bo == b"II":
            self.e = "<"
        elif bo == b"MM":
            self.e = ">"
        else:
            raise ValueError("not a TIFF file")
        magic = struct.unpack(self.e + "H", data[2:4])[0]
        if magic == 42:
            self.big = False
            ifd_off = struct.unpack(self.e + "I", data[4:8])[0]
        elif magic == 43:
            self.big = True
            offsize, zero, ifd_off = struct.unpack(self.e + "HHQ", data[4:16])
            if offsize != 8 or zero != 0:
                raise ValueError("malformed BigTIFF header")
        else:
            raise ValueError(f"unsupported TIFF magic {magic}")
        self.tags = self._read_ifd(ifd_off)

    def _read_ifd(self, off: int) -> Dict[int, tuple]:
        e, data = self.e, self.data
        if self.big:
            n = struct.unpack(e + "Q", data[off:off + 8])[0]
            base, esize, inline = off + 8, 20, 8
        else:
            n = struct.unpack(e + "H", data[off:off + 2])[0]
            base, esize, inline = off + 2, 12, 4
        tags: Dict[int, tuple] = {}
        for i in range(n):
            ent = data[base + esize * i: base + esize * (i + 1)]
            if self.big:
                tag, typ, cnt = struct.unpack(e + "HHQ", ent[:12])
                val_field = ent[12:20]
            else:
                tag, typ, cnt = struct.unpack(e + "HHI", ent[:8])
                val_field = ent[8:12]
            if typ not in _TYPE_SIZE:
                continue
            size = _TYPE_SIZE[typ] * cnt
            if size <= inline:
                raw = val_field[:size]
            else:
                voff = struct.unpack(e + ("Q" if self.big else "I"),
                                     val_field)[0]
                raw = data[voff:voff + size]
            if typ == 2:
                vals = (raw.split(b"\x00")[0].decode("latin-1"),)
            elif typ in (5, 10):
                base_fmt = "I" if typ == 5 else "i"
                nums = struct.unpack(e + base_fmt * (2 * cnt), raw)
                vals = tuple(nums[2 * k] / (nums[2 * k + 1] or 1) for k in range(cnt))
            else:
                vals = struct.unpack(e + _TYPE_FMT[typ] * cnt, raw)
            tags[tag] = vals
        return tags

    def tag(self, t: int, default=None):
        v = self.tags.get(t)
        if v is None:
            return default
        return v

    def tag1(self, t: int, default=None):
        v = self.tags.get(t)
        if v is None:
            return default
        return v[0]


def _dtype_from_tags(bits: int, fmt: int) -> np.dtype:
    if fmt == SF_FLOAT:
        return {32: np.dtype(np.float32), 64: np.dtype(np.float64)}[bits]
    if fmt == SF_INT:
        return {8: np.dtype(np.int8), 16: np.dtype(np.int16), 32: np.dtype(np.int32)}[bits]
    return {8: np.dtype(np.uint8), 16: np.dtype(np.uint16), 32: np.dtype(np.uint32)}[bits]


def _parse_gdal_metadata(xml: str) -> Dict[int, str]:
    """Extract per-band descriptions from GDAL_METADATA xml."""
    import re
    names: Dict[int, str] = {}
    for m in re.finditer(
            r'<Item\s+name="DESCRIPTION"\s+sample="(\d+)"[^>]*>([^<]*)</Item>', xml):
        names[int(m.group(1))] = m.group(2)
    return names


def _geo_from_tags(r: _Reader) -> GeoMeta:
    transform = None
    scale = r.tag(T_MODEL_PIXEL_SCALE)
    tie = r.tag(T_MODEL_TIEPOINT)
    mt = r.tag(T_MODEL_TRANSFORMATION)
    if mt is not None and len(mt) >= 16:
        transform = (mt[0], mt[1], mt[3], mt[4], mt[5], mt[7])
    elif scale is not None and tie is not None and len(tie) >= 6:
        sx, sy = scale[0], scale[1]
        i, j, _, x, y, _ = tie[:6]
        transform = (sx, 0.0, x - i * sx, 0.0, -sy, y + j * sy)
    crs = None
    gk = r.tag(T_GEO_KEY_DIRECTORY)
    ascii_params = r.tag1(T_GEO_ASCII_PARAMS, "")
    if gk is not None and len(gk) >= 4:
        nkeys = gk[3]
        keys = {}
        for k in range(nkeys):
            kid, loc, cnt, val = gk[4 + 4 * k: 8 + 4 * k]
            if loc == 0:
                keys[kid] = val
            elif loc == T_GEO_ASCII_PARAMS:
                keys[kid] = ascii_params[val:val + cnt].rstrip("|")
        # ProjectedCSTypeGeoKey=3072, GeographicTypeGeoKey=2048
        epsg = keys.get(3072) or keys.get(2048)
        if isinstance(epsg, int) and 1024 <= epsg <= 32767:
            crs = f"EPSG:{epsg}"
        elif 1026 in keys and isinstance(keys[1026], str) and keys[1026]:
            crs = keys[1026]  # GTCitationGeoKey (may carry WKT-ish text)
    nodata = None
    nd = r.tag1(T_GDAL_NODATA)
    if nd is not None:
        try:
            nodata = float(str(nd).strip())
        except ValueError:
            pass
    return GeoMeta(transform=transform, crs=crs, nodata=nodata)


def _decompress(chunk: bytes, comp: int, expected: int) -> bytes:
    if comp == COMP_NONE:
        return chunk
    if comp == COMP_LZW:
        return lzw_decode(chunk, expected)
    if comp in (COMP_DEFLATE, COMP_DEFLATE_ADOBE):
        return zlib.decompress(chunk)
    if comp == COMP_PACKBITS:
        return packbits_decode(chunk, expected)
    raise ValueError(f"unsupported compression {comp}")


def read_tiff(path: str) -> Tuple[np.ndarray, TiffInfo]:
    """Read a TIFF into a band-major ``(C, H, W)`` array + metadata."""
    with open(path, "rb") as f:
        data = f.read()
    r = _Reader(data)
    width = int(r.tag1(T_IMAGE_WIDTH))
    height = int(r.tag1(T_IMAGE_LENGTH))
    spp = int(r.tag1(T_SAMPLES_PER_PIXEL, 1))
    bits = r.tag(T_BITS_PER_SAMPLE, (8,) * spp)
    fmt = r.tag(T_SAMPLE_FORMAT, (SF_UINT,) * spp)
    if len(set(bits)) != 1 or len(set(fmt)) != 1:
        raise ValueError("mixed per-band dtypes unsupported")
    dtype = _dtype_from_tags(int(bits[0]), int(fmt[0]))
    comp = int(r.tag1(T_COMPRESSION, COMP_NONE))
    planar = int(r.tag1(T_PLANAR_CONFIG, 1))
    predictor = int(r.tag1(T_PREDICTOR, 1))
    bo = "<" if r.e == "<" else ">"
    dt = dtype.newbyteorder(bo)
    itemsize = dtype.itemsize

    out = np.empty((spp, height, width), dtype=dtype)

    tile_w = r.tag1(T_TILE_WIDTH)
    if tile_w is not None:  # tiled layout
        tile_w = int(tile_w)
        tile_h = int(r.tag1(T_TILE_LENGTH))
        offsets = r.tag(T_TILE_OFFSETS)
        counts = r.tag(T_TILE_BYTE_COUNTS)
        tiles_x = -(-width // tile_w)
        tiles_y = -(-height // tile_h)
        tiles_per_plane = tiles_x * tiles_y
        nplanes = spp if planar == 2 else 1
        samples_per_px = 1 if planar == 2 else spp
        for p in range(nplanes):
            for t in range(tiles_per_plane):
                idx = p * tiles_per_plane + t
                raw = data[offsets[idx]:offsets[idx] + counts[idx]]
                expected = tile_w * tile_h * samples_per_px * itemsize
                buf = _decompress(raw, comp, expected)
                if predictor == 3:
                    arr = _unpredict_float(buf[:expected], tile_h, tile_w,
                                           samples_per_px, itemsize,
                                           r.e).astype(dtype)
                else:
                    arr = np.frombuffer(buf[:expected], dtype=dt).reshape(
                        tile_h, tile_w, samples_per_px).astype(dtype)
                    if predictor == 2:
                        arr = _unpredict_horizontal(arr.copy())
                ty, tx = divmod(t, tiles_x)
                y0, x0 = ty * tile_h, tx * tile_w
                h = min(tile_h, height - y0)
                w = min(tile_w, width - x0)
                if planar == 2:
                    out[p, y0:y0 + h, x0:x0 + w] = arr[:h, :w, 0]
                else:
                    out[:, y0:y0 + h, x0:x0 + w] = np.moveaxis(arr[:h, :w, :], 2, 0)
    else:  # stripped layout
        rps = int(r.tag1(T_ROWS_PER_STRIP, height))
        offsets = r.tag(T_STRIP_OFFSETS)
        counts = r.tag(T_STRIP_BYTE_COUNTS)
        strips_per_plane = -(-height // rps)
        nplanes = spp if planar == 2 else 1
        samples_per_px = 1 if planar == 2 else spp
        for p in range(nplanes):
            for s in range(strips_per_plane):
                idx = p * strips_per_plane + s
                y0 = s * rps
                h = min(rps, height - y0)
                raw = data[offsets[idx]:offsets[idx] + counts[idx]]
                expected = h * width * samples_per_px * itemsize
                buf = _decompress(raw, comp, expected)
                if predictor == 3:
                    arr = _unpredict_float(buf[:expected], h, width,
                                           samples_per_px, itemsize,
                                           r.e).astype(dtype)
                else:
                    arr = np.frombuffer(buf[:expected], dtype=dt).reshape(
                        h, width, samples_per_px).astype(dtype)
                    if predictor == 2:
                        arr = _unpredict_horizontal(arr.copy())
                if planar == 2:
                    out[p, y0:y0 + h, :] = arr[:, :, 0]
                else:
                    out[:, y0:y0 + h, :] = np.moveaxis(arr, 2, 0)

    meta = _geo_from_tags(r)
    band_names = None
    gm = r.tag1(T_GDAL_METADATA)
    if gm:
        names = _parse_gdal_metadata(gm)
        if names:
            band_names = tuple(names.get(i) for i in range(spp))
    cmap = None
    cm = r.tag(T_COLORMAP)
    if cm is not None:
        n = len(cm) // 3
        cmap = np.array(cm, dtype=np.uint16).reshape(3, n).T
    info = TiffInfo(width=width, height=height, count=spp, dtype=dtype,
                    meta=meta, band_names=band_names, colormap=cmap,
                    compression=comp, tiled=tile_w is not None)
    return out, info


# --- writing -----------------------------------------------------------------

def _epsg_from_crs(crs: Optional[str]) -> Optional[int]:
    if not crs:
        return None
    s = crs.strip()
    if s.upper().startswith("EPSG:"):
        try:
            return int(s.split(":")[1])
        except ValueError:
            return None
    # try to pull AUTHORITY["EPSG","xxxx"] from the tail of a WKT string
    import re
    m = list(re.finditer(r'AUTHORITY\["EPSG",\s*"?(\d+)"?\]', s))
    if m:
        return int(m[-1].group(1))
    return None


class _Writer:
    """Classic or BigTIFF (version 43) single-IFD writer."""

    def __init__(self, big: bool = False):
        self.entries: List[Tuple[int, int, int, bytes]] = []  # tag, type, count, payload
        self.big = big

    def add(self, tag: int, typ: int, values) -> None:
        if typ == 2:
            if isinstance(values, str):
                payload = values.encode("latin-1") + b"\x00"
            else:
                payload = bytes(values) + b"\x00"
            cnt = len(payload)
        elif typ in (5, 10):
            base = "I" if typ == 5 else "i"
            flat = []
            for num, den in values:
                flat += [num, den]
            payload = struct.pack("<" + base * len(flat), *flat)
            cnt = len(values)
        else:
            vals = list(values) if hasattr(values, "__len__") else [values]
            payload = struct.pack("<" + _TYPE_FMT[typ] * len(vals), *vals)
            cnt = len(vals)
        self.entries.append((tag, typ, cnt, payload))

    def serialize(self, data_blocks: List[bytes], offset_tag: int,
                  count_tag: int) -> bytes:
        # layout: header | IFD | overflow tag payloads | data blocks
        big = self.big
        header = 16 if big else 8
        esize = 20 if big else 12
        inline = 8 if big else 4
        off_type = 16 if big else 4  # LONG8 vs LONG
        nexts = 8 if big else 4

        # placeholder entries so the IFD size is final before layout
        self._replace(offset_tag, off_type, [0] * len(data_blocks))
        self._replace(count_tag, off_type, [0] * len(data_blocks))
        self.entries.sort(key=lambda x: x[0])
        n = len(self.entries)
        ifd_off = header
        ifd_size = (8 if big else 2) + esize * n + nexts
        overflow_off = ifd_off + ifd_size
        overflow_size = sum(len(p) + (len(p) & 1)
                            for _, _, _, p in self.entries if len(p) > inline)
        data_off = overflow_off + overflow_size
        if data_off & 1:
            data_off += 1
        offsets = []
        counts = []
        pos = data_off
        for blk in data_blocks:
            offsets.append(pos)
            counts.append(len(blk))
            pos += len(blk) + (len(blk) & 1)
        self._replace(offset_tag, off_type, offsets)
        self._replace(count_tag, off_type, counts)
        self.entries.sort(key=lambda x: x[0])

        out = bytearray()
        if big:
            out += b"II" + struct.pack("<HHHQ", 43, 8, 0, ifd_off)
            out += struct.pack("<Q", n)
        else:
            out += b"II" + struct.pack("<HI", 42, ifd_off)
            out += struct.pack("<H", n)
        overflow = bytearray()
        opos = overflow_off
        for tag, typ, cnt, payload in self.entries:
            if big:
                out += struct.pack("<HHQ", tag, typ, cnt)
            else:
                out += struct.pack("<HHI", tag, typ, cnt)
            if len(payload) <= inline:
                out += payload + b"\x00" * (inline - len(payload))
            else:
                out += struct.pack("<Q" if big else "<I", opos)
                overflow += payload
                if len(payload) & 1:
                    overflow += b"\x00"
                opos += len(payload) + (len(payload) & 1)
        out += struct.pack("<Q" if big else "<I", 0)  # next IFD
        out += overflow
        while len(out) < data_off:
            out += b"\x00"
        for blk in data_blocks:
            out += blk
            if len(blk) & 1:
                out += b"\x00"
        return bytes(out)

    def _replace(self, tag: int, typ: int, values) -> None:
        self.entries = [e for e in self.entries if e[0] != tag]
        self.add(tag, typ, values)


def write_tiff(
    path: str,
    array: np.ndarray,
    meta: Optional[GeoMeta] = None,
    *,
    compression: str = "none",  # "none" | "lzw" | "deflate"
    tiled: bool = False,
    tile_size: int = 256,
    planar: int = 1,
    band_names: Optional[Sequence[Optional[str]]] = None,
    colormap: Optional[np.ndarray] = None,  # (N,3) uint8 or uint16
    predictor: Optional[bool] = None,
    bigtiff: bool = False,
) -> None:
    """Write a ``(C, H, W)`` or ``(H, W)`` array as a (Geo)TIFF."""
    arr = np.asarray(array)
    if arr.ndim == 2:
        arr = arr[None]
    if arr.ndim != 3:
        raise ValueError("array must be (H, W) or (C, H, W)")
    spp, height, width = arr.shape
    dtype = arr.dtype
    if dtype == np.bool_:
        arr = arr.astype(np.uint8)
        dtype = arr.dtype
    if dtype == np.int64:
        arr = arr.astype(np.int32)
        dtype = arr.dtype
    if dtype == np.float16:
        arr = arr.astype(np.float32)
        dtype = arr.dtype
    kind_map = {"u": SF_UINT, "i": SF_INT, "f": SF_FLOAT}
    if dtype.kind not in kind_map:
        raise ValueError(f"unsupported dtype {dtype}")
    fmt = kind_map[dtype.kind]
    bits = dtype.itemsize * 8
    comp = {"none": COMP_NONE, "lzw": COMP_LZW, "deflate": COMP_DEFLATE_ADOBE}[compression]
    if predictor is None:
        predictor = comp != COMP_NONE and dtype.kind in ("u", "i")

    arr_le = arr.astype(dtype.newbyteorder("<"), copy=False)

    def compress_block(block: np.ndarray) -> bytes:
        # block shape (rows, cols, samples)
        if predictor:
            block = _predict_horizontal(block)
        raw = block.tobytes()
        if comp == COMP_LZW:
            return lzw_encode(raw)
        if comp == COMP_DEFLATE_ADOBE:
            return zlib.compress(raw, 6)
        return raw

    raw_blocks: List[np.ndarray] = []
    w = _Writer(big=bigtiff)
    w.add(T_IMAGE_WIDTH, 4, width)
    w.add(T_IMAGE_LENGTH, 4, height)
    w.add(T_BITS_PER_SAMPLE, 3, [bits] * spp)
    w.add(T_COMPRESSION, 3, comp)
    photometric = 3 if colormap is not None and spp == 1 else (2 if spp >= 3 else 1)
    w.add(T_PHOTOMETRIC, 3, photometric)
    w.add(T_SAMPLES_PER_PIXEL, 3, spp)
    w.add(T_PLANAR_CONFIG, 3, planar)
    w.add(T_SAMPLE_FORMAT, 3, [fmt] * spp)
    if spp > 3 and photometric == 2:
        w.add(T_EXTRA_SAMPLES, 3, [0] * (spp - 3))
    if predictor:
        w.add(T_PREDICTOR, 3, 2)

    if tiled:
        th = tw = tile_size
        tiles_x = -(-width // tw)
        tiles_y = -(-height // th)
        w.add(T_TILE_WIDTH, 4, tw)
        w.add(T_TILE_LENGTH, 4, th)
        if planar == 2:
            for p in range(spp):
                for ty in range(tiles_y):
                    for tx in range(tiles_x):
                        tile = np.zeros((th, tw, 1), dtype=arr_le.dtype)
                        ys, xs = ty * th, tx * tw
                        h = min(th, height - ys)
                        ww = min(tw, width - xs)
                        tile[:h, :ww, 0] = arr_le[p, ys:ys + h, xs:xs + ww]
                        raw_blocks.append(tile)
        else:
            pix = np.moveaxis(arr_le, 0, 2)  # (H, W, C)
            for ty in range(tiles_y):
                for tx in range(tiles_x):
                    tile = np.zeros((th, tw, spp), dtype=arr_le.dtype)
                    ys, xs = ty * th, tx * tw
                    h = min(th, height - ys)
                    ww = min(tw, width - xs)
                    tile[:h, :ww, :] = pix[ys:ys + h, xs:xs + ww, :]
                    raw_blocks.append(tile)
        off_tag, cnt_tag = T_TILE_OFFSETS, T_TILE_BYTE_COUNTS
    else:
        # strips of ~64 KiB
        row_bytes = width * (spp if planar == 1 else 1) * dtype.itemsize
        rps = max(1, min(height, (1 << 16) // max(1, row_bytes)))
        nstrips = -(-height // rps)
        w.add(T_ROWS_PER_STRIP, 4, rps)
        if planar == 2:
            for p in range(spp):
                for s in range(nstrips):
                    ys = s * rps
                    h = min(rps, height - ys)
                    raw_blocks.append(arr_le[p, ys:ys + h, :][:, :, None])
        else:
            pix = np.moveaxis(arr_le, 0, 2)
            for s in range(nstrips):
                ys = s * rps
                h = min(rps, height - ys)
                raw_blocks.append(pix[ys:ys + h])
        off_tag, cnt_tag = T_STRIP_OFFSETS, T_STRIP_BYTE_COUNTS

    # compress blocks — in a thread pool when the native codec is in play
    # (ctypes calls release the GIL, so strips/tiles encode in parallel)
    if comp != COMP_NONE and len(raw_blocks) >= 4 and _native.available():
        import os as _os
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=min(8, _os.cpu_count() or 1)) as ex:
            blocks = list(ex.map(compress_block, raw_blocks))
    else:
        blocks = [compress_block(b) for b in raw_blocks]

    _add_aux_tags(w, meta, band_names, colormap, bits)

    payload = w.serialize(blocks, off_tag, cnt_tag)
    with open(path, "wb") as fh:
        fh.write(payload)


def _add_aux_tags(w: "_Writer", meta: Optional[GeoMeta],
                  band_names: Optional[Sequence[Optional[str]]],
                  colormap: Optional[np.ndarray], bits: int) -> None:
    """Geo / nodata / band-description / colormap tags shared by
    :func:`write_tiff` and :class:`TiffTileStreamWriter`."""
    if meta is not None and meta.transform is not None:
        a, b, c, d, e, f = meta.transform
        if b == 0.0 and d == 0.0:
            w.add(T_MODEL_PIXEL_SCALE, 12, [a, -e, 0.0])
            w.add(T_MODEL_TIEPOINT, 12, [0.0, 0.0, 0.0, c, f, 0.0])
        else:
            w.add(T_MODEL_TRANSFORMATION, 12,
                  [a, b, 0.0, c, d, e, 0.0, f, 0, 0, 0, 0, 0, 0, 0, 1])
    if meta is not None and meta.crs:
        epsg = _epsg_from_crs(meta.crs)
        keys = [(1024, 0, 1, 1), (1025, 0, 1, 1)]  # GTModelType=Projected, RasterPixelIsArea
        ascii_params = ""
        if epsg is not None:
            if epsg >= 32767 or (4000 <= epsg < 5000):
                keys[0] = (1024, 0, 1, 2)  # geographic
                keys.append((2048, 0, 1, epsg))
            else:
                keys.append((3072, 0, 1, epsg))
        citation = meta.crs if epsg is None else f"EPSG:{epsg}"
        keys.append((1026, T_GEO_ASCII_PARAMS, len(citation) + 1, len(ascii_params)))
        ascii_params += citation + "|"
        keys.sort(key=lambda k: k[0])
        directory = [1, 1, 0, len(keys)]
        for k in keys:
            directory += list(k)
        w.add(T_GEO_KEY_DIRECTORY, 3, directory)
        w.add(T_GEO_ASCII_PARAMS, 2, ascii_params)
    if meta is not None and meta.nodata is not None:
        nd = meta.nodata
        nd_str = str(int(nd)) if float(nd).is_integer() else repr(float(nd))
        w.add(T_GDAL_NODATA, 2, nd_str)
    if band_names is not None and any(band_names):
        items = "".join(
            f'<Item name="DESCRIPTION" sample="{i}" role="description">{n}</Item>'
            for i, n in enumerate(band_names) if n)
        w.add(T_GDAL_METADATA, 2, f"<GDALMetadata>{items}</GDALMetadata>")
    if colormap is not None:
        cm = np.asarray(colormap)
        if cm.dtype == np.uint8:
            cm = (cm.astype(np.uint16) * 257)
        n = 1 << bits
        full = np.zeros((n, 3), dtype=np.uint16)
        full[: cm.shape[0], :] = cm[:n]
        w.add(T_COLORMAP, 3, full.T.reshape(-1).tolist())


class TiffTileStreamWriter:
    """Incremental single-band tiled (Geo)TIFF writer.

    Feed label rows top-to-bottom with :meth:`write_rows`; every
    completed ``tile_size``-row band of tiles is handed to a thread pool
    for compression IMMEDIATELY (the native LZW codec releases the GIL),
    so encoding overlaps whatever the caller does next — in
    ``pipeline.large_scene.classify_large_scene`` (``writer=``) that is
    the card computing the next classification tile.
    :meth:`close` assembles the same tag structure as :func:`write_tiff`
    — the file is byte-identical to a whole-array write (tested).

    Writer contract: LZW, 256-px tiles, nodata, colormap, band
    description."""

    def __init__(self, path: str, height: int, width: int, dtype,
                 meta: Optional[GeoMeta] = None, *,
                 compression: str = "lzw", tile_size: int = 256,
                 band_names: Optional[Sequence[Optional[str]]] = None,
                 colormap: Optional[np.ndarray] = None,
                 predictor: Optional[bool] = None,
                 bigtiff: bool = False, max_workers: Optional[int] = None):
        import os as _os
        from concurrent.futures import ThreadPoolExecutor

        dtype = np.dtype(dtype)
        if dtype == np.int64:
            dtype = np.dtype(np.int32)
        if dtype.kind not in ("u", "i", "f"):
            raise ValueError(f"unsupported dtype {dtype}")
        self._path = path
        self._height, self._width = int(height), int(width)
        self._dtype_le = dtype.newbyteorder("<")
        self._meta = meta
        self._band_names = band_names
        self._colormap = colormap
        self._bigtiff = bigtiff
        self._tile = int(tile_size)
        self._comp = {"none": COMP_NONE, "lzw": COMP_LZW,
                      "deflate": COMP_DEFLATE_ADOBE}[compression]
        self._predict = (predictor if predictor is not None
                         else self._comp != COMP_NONE
                         and dtype.kind in ("u", "i"))
        self._tiles_x = -(-self._width // self._tile)
        self._rows_seen = 0
        self._buf: List[np.ndarray] = []
        self._buf_rows = 0
        self._futures: List = []
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers or min(8, _os.cpu_count() or 1))

    def _compress(self, block: np.ndarray) -> bytes:
        if self._predict:
            block = _predict_horizontal(block)
        raw = block.tobytes()
        if self._comp == COMP_LZW:
            return lzw_encode(raw)
        if self._comp == COMP_DEFLATE_ADOBE:
            return zlib.compress(raw, 6)
        return raw

    def _flush_band(self, band: np.ndarray) -> None:
        # partial bands/tiles are zero-padded exactly like write_tiff's
        th = tw = self._tile
        for tx in range(self._tiles_x):
            xs = tx * tw
            tile = np.zeros((th, tw, 1), dtype=self._dtype_le)
            ww = min(tw, self._width - xs)
            tile[:band.shape[0], :ww, 0] = band[:, xs:xs + ww]
            self._futures.append(self._pool.submit(self._compress, tile))

    def write_rows(self, rows: np.ndarray) -> None:
        """Append ``(r, W)`` rows (top-to-bottom, in order)."""
        rows = np.asarray(rows)
        if rows.ndim != 2 or rows.shape[1] != self._width:
            raise ValueError(f"rows must be (r, {self._width}), "
                             f"got {rows.shape}")
        if self._rows_seen + rows.shape[0] > self._height:
            raise ValueError("more rows than the declared height")
        rows = rows.astype(self._dtype_le, copy=False)
        self._rows_seen += rows.shape[0]
        self._buf.append(rows)
        self._buf_rows += rows.shape[0]
        if self._buf_rows >= self._tile or self._rows_seen == self._height:
            band = np.concatenate(self._buf, axis=0) if len(self._buf) > 1 \
                else self._buf[0]
            while band.shape[0] >= self._tile:
                self._flush_band(band[:self._tile])
                band = band[self._tile:]
            if self._rows_seen == self._height and band.shape[0] > 0:
                self._flush_band(band)
                band = band[:0]
            self._buf = [band] if band.size else []
            self._buf_rows = band.shape[0] if band.size else 0

    def close(self) -> None:
        """Finalize: wait for encoders, assemble tags, write the file."""
        if self._rows_seen != self._height:
            self._pool.shutdown(wait=False)
            raise ValueError(f"only {self._rows_seen} of {self._height} "
                             f"rows were written")
        blocks = [f.result() for f in self._futures]
        self._pool.shutdown(wait=True)
        dtype = np.dtype(self._dtype_le.newbyteorder("="))
        kind_map = {"u": SF_UINT, "i": SF_INT, "f": SF_FLOAT}
        bits = dtype.itemsize * 8
        w = _Writer(big=self._bigtiff)
        w.add(T_IMAGE_WIDTH, 4, self._width)
        w.add(T_IMAGE_LENGTH, 4, self._height)
        w.add(T_BITS_PER_SAMPLE, 3, [bits])
        w.add(T_COMPRESSION, 3, self._comp)
        w.add(T_PHOTOMETRIC, 3,
              3 if self._colormap is not None else 1)
        w.add(T_SAMPLES_PER_PIXEL, 3, 1)
        w.add(T_PLANAR_CONFIG, 3, 1)
        w.add(T_SAMPLE_FORMAT, 3, [kind_map[dtype.kind]])
        if self._predict:
            w.add(T_PREDICTOR, 3, 2)
        w.add(T_TILE_WIDTH, 4, self._tile)
        w.add(T_TILE_LENGTH, 4, self._tile)
        _add_aux_tags(w, self._meta, self._band_names, self._colormap, bits)
        payload = w.serialize(blocks, T_TILE_OFFSETS, T_TILE_BYTE_COUNTS)
        with open(self._path, "wb") as fh:
            fh.write(payload)

    def __enter__(self) -> "TiffTileStreamWriter":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        if exc_type is None:
            self.close()
        else:
            self._pool.shutdown(wait=False)
