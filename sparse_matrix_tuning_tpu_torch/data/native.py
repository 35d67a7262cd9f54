"""The C++ collator and the background prefetcher that feed `fit` its
training batches (PyTorch twin of `sparse_matrix_tuning_tpu.data.native`).

At first use one `g++ -O3 -shared -fPIC` compiles csrc/collate.cpp into
build/torch_native/libsmt_collate_<hash>.so, where <hash> covers the
source and the flags, so an edit rebuilds and an unchanged tree reuses the
library; processes that build at once (a job's ranks) take turns on
ops/cuda/_build.build_once's lock. The library exports a plain C
interface, bound with ctypes, which releases the GIL for the call, so
PrefetchLoader's thread collates while the main thread runs a step. A
failed build raises, with the compiler's output: no path falls back to
the numpy collator (data/sft.batch_iterator, this one's plain twin, which
the tests hold it against and the eval batches still take).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import queue
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from sparse_matrix_tuning_tpu_torch.data.sft import IGNORE_INDEX, _bucket_for

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "collate.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32
SIGNATURES = {
    # offsets, n_examples, indices, n_rows, out
    "smt_max_len": (_P, _I64, _P, _I64, _P),
    # ids, labels, offsets, n_examples, indices, n_rows, seq_len, pad_id,
    # ignore_index, out_ids, out_labels, out_mask
    "smt_fill_batch": (_P, _P, _P, _I64, _P, _I64, _I64, _I32, _I32, _P, _P, _P),
}

_lib: Optional[ctypes.CDLL] = None
_load_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libsmt_collate_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:   # no compiler at all
        raise RuntimeError(f"the C++ collator's build failed: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"the C++ collator's build failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    tmp.replace(out)   # atomic: a reader sees all or nothing


def build() -> Path:
    """Compile csrc/collate.cpp unless its library exists, one process at
    a time."""
    from sparse_matrix_tuning_tpu_torch.ops.cuda._build import build_once
    return build_once(library_path(), _compile)


def load() -> ctypes.CDLL:
    """Build if needed, then load the library once per process."""
    global _lib
    with _load_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


class TokenArena:
    """Dataset examples end to end in contiguous int32 arenas with int64
    offsets: example e is ids[offsets[e]:offsets[e + 1]] (and labels
    alike), the layout the C++ collator reads."""

    def __init__(self, input_ids: Sequence[np.ndarray], labels: Sequence[np.ndarray]):
        if len(input_ids) != len(labels):
            raise ValueError(f"{len(input_ids)} input_ids against {len(labels)} labels")
        lens = np.fromiter((len(x) for x in input_ids), np.int64, len(input_ids))
        if any(len(b) != n for b, n in zip(labels, lens)):
            raise ValueError("an example's labels differ in length from its input_ids")
        self.offsets = np.zeros(len(input_ids) + 1, np.int64)
        np.cumsum(lens, out=self.offsets[1:])
        self.ids = np.empty(int(self.offsets[-1]), np.int32)
        self.labels = np.empty(int(self.offsets[-1]), np.int32)
        for i, (a, b) in enumerate(zip(input_ids, labels)):
            s, e = self.offsets[i], self.offsets[i + 1]
            self.ids[s:e] = a
            self.labels[s:e] = b

    def __len__(self) -> int:
        return len(self.offsets) - 1

    @classmethod
    def from_dataset(cls, ds) -> "TokenArena":
        return cls(ds.input_ids, ds.labels)


def _indices(indices) -> np.ndarray:
    idx = np.ascontiguousarray(indices, np.int64)
    if idx.ndim != 1:
        raise ValueError(f"indices must be 1-D, not {idx.shape}")
    return idx


def max_len(arena: TokenArena, indices) -> int:
    """The longest of the examples at `indices`."""
    idx = _indices(indices)
    out = np.zeros(1, np.int64)
    if load().smt_max_len(arena.offsets.ctypes.data, len(arena), idx.ctypes.data, len(idx),
                          out.ctypes.data):
        raise IndexError(f"an index of {idx.tolist()} lies outside the {len(arena)} examples")
    return int(out[0])


def collate_native(arena: TokenArena, indices, pad_id: int, seq_len: int,
                   ignore_index: int = IGNORE_INDEX) -> Dict[str, np.ndarray]:
    """The (len(indices), seq_len) int32 batch of the examples at `indices`:
    ids truncated to seq_len and right-padded with pad_id, labels padded
    with ignore_index, the attention mask 1 over the tokens (what
    data/sft.collate computes)."""
    idx = _indices(indices)
    if seq_len < 0:
        raise ValueError(f"seq_len {seq_len}")
    out = {k: np.empty((len(idx), seq_len), np.int32)
           for k in ("input_ids", "labels", "attention_mask")}
    if load().smt_fill_batch(arena.ids.ctypes.data, arena.labels.ctypes.data,
                             arena.offsets.ctypes.data, len(arena), idx.ctypes.data, len(idx),
                             seq_len, pad_id, ignore_index, out["input_ids"].ctypes.data,
                             out["labels"].ctypes.data, out["attention_mask"].ctypes.data):
        raise IndexError(f"an index of {idx.tolist()} lies outside the {len(arena)} examples")
    return out


def native_batch_iterator(arena: TokenArena, batch_size: int, pad_token_id: int,
                          buckets: Sequence[int], seed: int, epoch: int,
                          shuffle: bool = True, drop_last: bool = True
                          ) -> Iterator[Dict[str, np.ndarray]]:
    """data/sft.batch_iterator's batches, collated in C++: the order
    default_rng(hash((seed, epoch)) % 2**31), the wrap-pad of a last short
    batch under drop_last=False, each batch at the smallest bucket that
    covers its longest member."""
    order = np.arange(len(arena), dtype=np.int64)
    if shuffle:
        order = np.random.default_rng(hash((seed, epoch)) % (2 ** 31)).permutation(order)
    n_full = len(order) // batch_size if drop_last else -(-len(order) // batch_size)
    for bi in range(n_full):
        idx = order[bi * batch_size:(bi + 1) * batch_size]
        if len(idx) < batch_size:  # only when drop_last=False: wrap-pad
            idx = np.concatenate([idx, order[: batch_size - len(idx)]])
        yield collate_native(arena, idx, pad_token_id,
                             _bucket_for(max_len(arena, idx), buckets))


class PrefetchLoader:
    """Iterates iterator_factory()'s items, made `depth` ahead by a daemon
    thread while the consumer works (the C++ collation and the device
    steps release the GIL). An error in the thread is raised to the
    consumer; a consumer that stops early (a break, an exception, close())
    releases the thread, which ends."""

    _DONE = object()

    def __init__(self, iterator_factory, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._factory = iterator_factory
        self._thread: Optional[threading.Thread] = None

    def __iter__(self):
        it = self._factory()
        error: list = []
        stop = threading.Event()  # set when the consumer is gone

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in it:
                    if not put(item):
                        return   # the consumer is gone: end
            except BaseException as e:   # handed to the consumer, re-raised there
                error.append(e)
            finally:
                put(self._DONE)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()
        try:
            while True:
                item = self._q.get()
                if item is self._DONE:
                    break
                yield item
        finally:
            # a normal end, a break or an exception: release a blocked put
            stop.set()
            while True:
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    break
            self._thread.join()
        if error:
            raise error[0]
