"""MDS shard format writer, reader and index merge, the port's own copy of
micro_diffusion_tpu/datasets/mds.py (``MDSWriter`` :86, ``MDSReader`` :188,
``merge_index`` :287).

Binary- and index-compatible with mosaicml-streaming's MDS format, the
reference's data interchange format, so shards written by either package (or by
streaming) read in the other:

    index.json: {"version": 2, "shards": [<shard-info>...]}
    shard file: uint32 num_samples
                uint32 offsets[num_samples + 1]   (absolute byte offsets)
                sample blobs
    sample:     uint32 sizes[<variable-size columns>] then encoded columns in order

Encodings: bytes, str, jpeg, png, int, int32, int64, uint32, float32, json. The
reader memory-maps the shards. ``read_many`` reads a batch of 4 samples or more
through the native parallel-``pread`` gather (``datasets/native.py``, host C++),
as the JAX reader does (mds.py:264-285), and slices smaller ones from the maps
(``read_blobs_mmap``).
"""

import io
import json
import os
import struct
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from . import native

NATIVE_MIN_BATCH = 4  # read_many's native gather from this many samples on (JAX's)
_FIXED = {"int": 8, "int64": 8, "int32": 4, "uint32": 4, "float32": 4}


def _encode(encoding: str, value: Any) -> bytes:
    if encoding == "bytes":
        return bytes(value)
    if encoding == "str":
        return str(value).encode("utf-8")
    if encoding == "json":
        return json.dumps(value).encode("utf-8")
    if encoding in ("int", "int64"):
        return struct.pack("<q", int(value))
    if encoding == "int32":
        return struct.pack("<i", int(value))
    if encoding == "uint32":
        return struct.pack("<I", int(value))
    if encoding == "float32":
        return struct.pack("<f", float(value))
    if encoding in ("jpeg", "png"):
        if isinstance(value, (bytes, bytearray)):
            return bytes(value)
        buf = io.BytesIO()
        value.save(buf, format="JPEG" if encoding == "jpeg" else "PNG", quality=95)
        return buf.getvalue()
    raise ValueError(f"unsupported MDS encoding: {encoding}")


def _decode(encoding: str, data) -> Any:
    """One column from its bytes, or a view of them (``read_many``'s native path):
    a ``bytes`` column stays a view, equal to the bytes."""
    if encoding == "bytes":
        return data
    if encoding == "str":
        return bytes(data).decode("utf-8")
    if encoding == "json":
        return json.loads(bytes(data).decode("utf-8"))
    if encoding in ("int", "int64"):
        return struct.unpack("<q", data)[0]
    if encoding == "int32":
        return struct.unpack("<i", data)[0]
    if encoding == "uint32":
        return struct.unpack("<I", data)[0]
    if encoding == "float32":
        return struct.unpack("<f", data)[0]
    if encoding in ("jpeg", "png"):
        from PIL import Image

        return Image.open(io.BytesIO(data))
    raise ValueError(f"unsupported MDS encoding: {encoding}")


class MDSWriter:
    """Writes MDS shards and index.json (mosaicml-streaming compatible): no
    compression, ``size_limit`` bytes per shard (256 MB in the reference's
    prepare pipelines)."""

    def __init__(self, out: str, columns: Dict[str, str], compression: Optional[str] = None,
                 size_limit: int = 256 * (1 << 20), **_: Any):
        if compression not in (None, ""):
            raise ValueError(f"compression {compression!r} is not supported")
        self.dirname = out
        os.makedirs(out, exist_ok=True)
        self.column_names = list(columns)
        self.column_encodings = [columns[k] for k in self.column_names]
        self.column_sizes = [_FIXED.get(e) for e in self.column_encodings]
        self.size_limit = size_limit
        self._samples: List[bytes] = []
        self._bytes = 0
        self._shards: List[dict] = []
        self._finished = False

    def _encode_sample(self, sample: Dict[str, Any]) -> bytes:
        sizes, data = [], []
        for name, enc, size in zip(self.column_names, self.column_encodings,
                                   self.column_sizes):
            datum = _encode(enc, sample[name])
            if size is None:
                sizes.append(len(datum))
            elif len(datum) != size:
                raise ValueError(f"column {name} ({enc}) encodes to {len(datum)} bytes, "
                                 f"not {size}")
            data.append(datum)
        return np.array(sizes, np.uint32).tobytes() + b"".join(data)

    def write(self, sample: Dict[str, Any]) -> None:
        if self._finished:
            raise RuntimeError("write after finish")
        blob = self._encode_sample(sample)
        if self._samples and self._bytes + len(blob) > self.size_limit:
            self._flush_shard()
        self._samples.append(blob)
        self._bytes += len(blob)

    def _flush_shard(self) -> None:
        if not self._samples:
            return
        n = len(self._samples)
        sizes = np.array([len(s) for s in self._samples], np.int64)
        header = 4 + 4 * (n + 1)
        offsets = (np.concatenate([np.zeros(1, np.int64), np.cumsum(sizes)])
                   + header).astype(np.uint32)
        payload = np.uint32(n).tobytes() + offsets.tobytes() + b"".join(self._samples)
        basename = f"shard.{len(self._shards):05}.mds"
        with open(os.path.join(self.dirname, basename), "wb") as f:
            f.write(payload)
        self._shards.append({
            "column_encodings": self.column_encodings,
            "column_names": self.column_names,
            "column_sizes": self.column_sizes,
            "compression": None,
            "format": "mds",
            "hashes": [],
            "raw_data": {"basename": basename, "bytes": len(payload), "hashes": {}},
            "samples": n,
            "size_limit": self.size_limit,
            "version": 2,
            "zip_data": None,
        })
        self._samples = []
        self._bytes = 0

    def finish(self) -> None:
        self._flush_shard()
        with open(os.path.join(self.dirname, "index.json"), "w") as f:
            json.dump({"version": 2, "shards": self._shards}, f)
        self._finished = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finish()


class MDSReader:
    """Random-access reader over one MDS dataset directory (index.json + shards),
    the shards memory-mapped on first use."""

    def __init__(self, dirname: str):
        self.dirname = dirname
        with open(os.path.join(dirname, "index.json")) as f:
            index = json.load(f)
        if index.get("version") != 2:
            raise ValueError(f"{dirname}: MDS index version {index.get('version')}, not 2")
        self.shards = index["shards"]
        self._cum = np.cumsum([0] + [s["samples"] for s in self.shards])
        self._mmaps: Dict[int, np.memmap] = {}

    def __len__(self) -> int:
        return int(self._cum[-1])

    def _shard_data(self, shard_idx: int) -> np.memmap:
        if shard_idx not in self._mmaps:
            basename = self.shards[shard_idx]["raw_data"]["basename"]
            self._mmaps[shard_idx] = np.memmap(os.path.join(self.dirname, basename),
                                               dtype=np.uint8, mode="r")
        return self._mmaps[shard_idx]

    def _locate(self, idx: int):
        """(shard index, begin, end) of sample ``idx``'s blob."""
        shard_idx = int(np.searchsorted(self._cum, idx, side="right")) - 1
        off = 4 + 4 * (idx - int(self._cum[shard_idx]))
        data = self._shard_data(shard_idx)
        begin, end = np.frombuffer(data[off:off + 8].tobytes(), np.uint32)
        return shard_idx, int(begin), int(end)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        if idx < 0:
            idx += len(self)
        if not 0 <= idx < len(self):
            raise IndexError(idx)
        shard_idx, begin, end = self._locate(idx)
        blob = self._shard_data(shard_idx)[begin:end].tobytes()
        return self._decode_sample(self.shards[shard_idx], blob)

    @staticmethod
    def _decode_sample(shard: dict, blob: bytes) -> Dict[str, Any]:
        col_sizes, pos = [], 0
        for s in shard["column_sizes"]:  # head: uint32 size per variable-size column
            if s is None:
                (sz,) = struct.unpack_from("<I", blob, pos)
                pos += 4
                col_sizes.append(sz)
            else:
                col_sizes.append(s)
        out = {}
        for name, enc, sz in zip(shard["column_names"], shard["column_encodings"], col_sizes):
            out[name] = _decode(enc, blob[pos:pos + sz])
            pos += sz
        return out

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        for i in range(len(self)):
            yield self[i]

    def sample_range(self, idx: int):
        """(shard file path, shard index, begin, length) of sample ``idx``'s blob."""
        shard_idx, begin, end = self._locate(idx)
        path = os.path.join(self.dirname, self.shards[shard_idx]["raw_data"]["basename"])
        return path, shard_idx, begin, end - begin

    def read_blobs_mmap(self, ranges) -> List[bytes]:
        """The blobs of ``sample_range`` tuples, sliced from the memory maps one by
        one: the plain path beside the native gather."""
        return [self._shard_data(shard_idx)[begin:begin + length].tobytes()
                for _, shard_idx, begin, length in ranges]

    def read_many(self, indices) -> List[Dict[str, Any]]:
        """Decode many samples. The blobs of ``NATIVE_MIN_BATCH`` samples or more
        are read by the native gather (``datasets/native.py``), fewer are sliced
        from the memory maps; the decoded samples are the same."""
        ranges = [self.sample_range(int(i)) for i in indices]
        if len(ranges) >= NATIVE_MIN_BATCH:
            blobs = native.gather([r[0] for r in ranges], [r[2] for r in ranges],
                                  [r[3] for r in ranges])
        else:
            blobs = self.read_blobs_mmap(ranges)
        return [self._decode_sample(self.shards[r[1]], b) for r, b in zip(ranges, blobs)]


def merge_index(root: str, subdirs: Optional[Sequence[str]] = None) -> None:
    """Merge per-rank sub-directory indexes into one root index.json, rewriting shard
    basenames as '<subdir>/<basename>' (streaming.base.util.merge_index parity;
    reference precompute.py:242-248). The subdirectories go in ``sorted()`` order of
    their names, as in the JAX package: "10" before "2"."""
    if subdirs is None:
        subdirs = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d))
            and os.path.exists(os.path.join(root, d, "index.json")))
    shards = []
    for sub in subdirs:
        with open(os.path.join(root, sub, "index.json")) as f:
            index = json.load(f)
        for s in index["shards"]:
            s = dict(s)
            rd = dict(s["raw_data"])
            rd["basename"] = os.path.join(sub, rd["basename"])
            s["raw_data"] = rd
            shards.append(s)
    with open(os.path.join(root, "index.json"), "w") as f:
        json.dump({"version": 2, "shards": shards}, f)
