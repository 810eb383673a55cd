"""The CLIP tokenizer of the port: ``csrc/clip_tokenizer.cpp`` over ctypes.

Port of ``followyourclick_tpu/utils/native_tokenizer.py``. The JAX package
tries ``transformers.CLIPTokenizer`` first; the card's machine has no
``transformers``, so the port tokenizes with its own copy of the native
BPE tokenizer, whose ids equal ``CLIPTokenizer``'s (the vocabulary is
derived from ``merges.txt`` alone, as the published ``vocab.json`` is).
The library is built with the host compiler at the first tokenizer made
(``ops/_build.build_host_library``, under a lock, into the git-ignored
``_build/``), never at import.
"""

from __future__ import annotations

import ctypes
import os
import types
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np

from followyourclick_tpu_torch.ops import _build

SOURCE = _build.CSRC / "clip_tokenizer.cpp"


def load_library(build_dir: Optional[Path] = None) -> ctypes.CDLL:
    """Build (once) and load the tokenizer library, signatures declared."""
    lib = ctypes.CDLL(str(_build.build_host_library(
        SOURCE, Path(build_dir) if build_dir else _build.BUILD_DIR)))
    lib.fyc_tokenizer_create.restype = ctypes.c_void_p
    lib.fyc_tokenizer_create.argtypes = [ctypes.c_char_p]
    lib.fyc_tokenizer_destroy.argtypes = [ctypes.c_void_p]
    lib.fyc_tokenizer_encode.restype = ctypes.c_int
    lib.fyc_tokenizer_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.c_int]
    return lib


class NativeCLIPTokenizer:
    """``tokenizer(texts, padding="max_length", max_length=77,
    truncation=True, return_tensors="np").input_ids``: ``<bos>`` tokens
    ``<eos>``, cut to ``max_length`` with ``<eos>`` kept last, padded with
    ``<eos>`` (``CLIPTokenizer``'s pad token), as int64 numpy."""

    model_max_length = 77

    def __init__(self, merges_file: str, build_dir: Optional[Path] = None):
        if os.path.isdir(merges_file):
            merges_file = os.path.join(merges_file, "merges.txt")
        if not os.path.exists(merges_file):
            raise FileNotFoundError(merges_file)
        self._lib = load_library(build_dir)
        self._handle = self._lib.fyc_tokenizer_create(merges_file.encode())
        if not self._handle:
            raise RuntimeError(f"failed to load merges from {merges_file}")

    def encode(self, text: str, max_length: int = 77) -> np.ndarray:
        out = (ctypes.c_int * max_length)()
        self._lib.fyc_tokenizer_encode(self._handle, text.encode("utf-8"),
                                       out, max_length)
        return np.ctypeslib.as_array(out).copy()

    def __call__(self, texts: Union[str, Sequence[str]], padding=None,
                 max_length: int = 77, truncation: bool = True,
                 return_tensors: str = "np"):
        if isinstance(texts, str):
            texts = [texts]
        ids = np.stack([self.encode(t, max_length) for t in texts]).astype(
            np.int64)
        return types.SimpleNamespace(input_ids=ids)

    def __del__(self):  # pragma: no cover
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.fyc_tokenizer_destroy(handle)
            self._handle = None
