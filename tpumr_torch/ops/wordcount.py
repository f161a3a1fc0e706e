"""WordCount's map: ``bytes.split()`` tokens of a split, counted on the host.

Counterpart of ``tpumr/ops/wordcount.py``. Tokenizing is host work in the
JAX package too, so this is a numpy copy and no device code: a split of
64 KiB or more goes through :func:`tokenize_count`, a vectorized
byte-matrix tokenizer, a smaller one (or any, with
``tpumr.wordcount.vectorized=false``) through a ``Counter``. Either way a
map emits one record per distinct word of its split. The JAX package's
native single-pass tokenizer (``native/textkit/tokencount.c``) is not
ported; the numpy path yields the same tokens and counts.
"""

from __future__ import annotations

from collections import Counter
from typing import Iterable, Iterator

import numpy as np

from tpumr_torch.mapred.api import Mapper
from tpumr_torch.ops.registry import KernelMapper, register_kernel

#: bytes.split() whitespace: \t \n \v \f \r and space
_WS_TABLE = np.zeros(256, dtype=bool)
_WS_TABLE[[9, 10, 11, 12, 13, 32]] = True


def tokenize_count(data) -> "Iterator[tuple[bytes, int]]":
    """(token, count) for every distinct ``bytes.split()`` token of
    ``data`` (bytes or a uint8 array, read only): token edges from one
    whitespace scan, then per token length one gather into a matrix and
    one ``np.unique`` (lengths up to 8 packed into one uint64 each)."""
    buf = (data if isinstance(data, np.ndarray)
           else np.frombuffer(data, dtype=np.uint8))
    if buf.size == 0:
        return
    tok = (~_WS_TABLE[buf]).view(np.int8)
    # +1 where a run of non-whitespace starts, -1 one past its end
    edges = np.diff(tok, prepend=np.int8(0), append=np.int8(0))
    starts = np.flatnonzero(edges == 1)
    lengths = np.flatnonzero(edges == -1) - starts
    for length in np.unique(lengths):
        width = int(length)
        s = starts[lengths == width]
        mat = buf[s[:, None] + np.arange(width, dtype=s.dtype)]
        if width <= 8:
            packed = np.zeros((mat.shape[0], 8), dtype=np.uint8)
            packed[:, :width] = mat
            uniq, counts = np.unique(packed.view("<u8").ravel(),
                                     return_counts=True)
            raw = uniq.astype("<u8").tobytes()
            for i in range(uniq.size):
                yield raw[i * 8: i * 8 + width], int(counts[i])
        else:
            uniq, counts = np.unique(
                np.ascontiguousarray(mat).view(f"V{width}").ravel(),
                return_counts=True)
            raw = uniq.tobytes()
            for i in range(uniq.size):
                yield raw[i * width: (i + 1) * width], int(counts[i])


class WordCountCpuMapper(Mapper):
    def map(self, key, value, output, reporter):
        for w in value.split():
            output.collect(w, 1)


class WordCountKernel(KernelMapper):
    """A host kernel: no launch, its ``map_batch`` runs on the host batch
    on either slot."""

    name = "wordcount"
    cpu_mapper_class = WordCountCpuMapper

    def map_batch(self, batch, conf, task) -> Iterable[tuple]:
        if batch.num_records == 0:
            return
        # a RawTextInputFormat split is one record: its bytes as they are
        data = (batch.value_data if batch.num_records == 1
                else batch.joined_values())
        nbytes = data.size if isinstance(data, np.ndarray) else len(data)
        if nbytes < 1 << 16 or not conf.get_boolean(
                "tpumr.wordcount.vectorized", True):
            raw = data.tobytes() if isinstance(data, np.ndarray) else data
            for word, cnt in Counter(raw.split()).items():
                yield word.decode("utf-8", errors="replace"), cnt
            return
        for word, cnt in tokenize_count(data):
            yield word.decode("utf-8", errors="replace"), cnt

    map_batch_cpu = map_batch


register_kernel(WordCountKernel())
