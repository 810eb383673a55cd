"""The port's CLIP tokenizer (``utils/native_tokenizer.py`` over
``csrc/clip_tokenizer.cpp``) against ``transformers.CLIPTokenizer``, and its
build at first use.

Both tokenizers read the same synthetic ``merges.txt`` (the repository ships
no CLIP vocabulary; ``CLIPTokenizer`` gets the ``vocab.json`` derived from
it, as the published one is) and must give the same ids, padding and
truncation included, on the strings of ``tests/test_native.py``. The
library is built by the host compiler into a build directory at the first
tokenizer made; four processes that start on an empty directory together
must all load it (one builds under the lock, the others wait, and nobody
opens a half-written file). The JAX package's tokenizer is not called here:
it builds into ``native/build`` without a lock.
"""

import json
import multiprocessing
import os

import numpy as np
import pytest

from followyourclick_tpu_torch.utils.native_tokenizer import (
    NativeCLIPTokenizer,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module's torch work (restored after): the
    suite runs six workers on the machine's cores, and eight spinning
    OpenMP threads a worker stretch a tiny model's CPU run several-fold.
    The port-test modules of this change import it."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MERGES = [("c", "a"), ("ca", "t</w>"), ("d", "o"), ("do", "g</w>"),
          ("t", "h"), ("th", "e</w>"), ("i", "n"), ("in", "g</w>"),
          ("e", "r</w>"), ("a", "t</w>")]


def _bytes_to_unicode():
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _vocab(merges):
    chars = list(_bytes_to_unicode().values())
    vocab = chars + [v + "</w>" for v in chars] + [a + b for a, b in merges]
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    return {tok: i for i, tok in enumerate(vocab)}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tok")
    (d / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in MERGES) + "\n")
    (d / "vocab.json").write_text(json.dumps(_vocab(MERGES)))
    return d


@pytest.fixture(scope="module")
def pair(files):
    transformers = pytest.importorskip("transformers")
    hf = transformers.CLIPTokenizer(vocab_file=str(files / "vocab.json"),
                                    merges_file=str(files / "merges.txt"))
    return hf, NativeCLIPTokenizer(str(files / "merges.txt"),
                                   build_dir=files / "build")


@pytest.mark.parametrize("text", [
    "the cat", "a dog eating", "The CAT!!", "cater dogging",
    "it's the dog's cat", "猫", "123 cats", "   spaced   out   ", "",
    "cat " * 200])
def test_ids_match_transformers(pair, text):
    hf, port = pair
    want = hf([text], padding="max_length", max_length=77, truncation=True,
              return_tensors="np").input_ids
    got = port([text]).input_ids
    assert got.dtype == np.int64 and got.shape == (1, 77)
    np.testing.assert_array_equal(got, want)


def test_batch_and_directory_argument(pair, files):
    """A list tokenizes row by row; a directory stands for its
    ``merges.txt``; a missing file raises."""
    hf, port = pair
    texts = ["the cat", "a dog eating"]
    np.testing.assert_array_equal(
        port(texts).input_ids,
        hf(texts, padding="max_length", max_length=77, truncation=True,
           return_tensors="np").input_ids)
    from_dir = NativeCLIPTokenizer(str(files), build_dir=files / "build")
    np.testing.assert_array_equal(from_dir(texts).input_ids,
                                  port(texts).input_ids)
    with pytest.raises(FileNotFoundError):
        NativeCLIPTokenizer(str(files / "no_such.txt"),
                            build_dir=files / "build")


def _build_and_encode(args):
    merges, build_dir = args
    tok = NativeCLIPTokenizer(merges, build_dir=build_dir)
    return tok(["the cat"]).input_ids.tolist()


def test_concurrent_first_builds_all_load(files, tmp_path):
    """Four processes on an empty build directory at once: one library
    appears (no temporary left), and every process loads it and encodes."""
    build_dir = tmp_path / "build"
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(4) as pool:
        out = pool.map(_build_and_encode,
                       [(str(files / "merges.txt"), str(build_dir))] * 4)
    assert all(o == out[0] for o in out)
    libs = sorted(p for p in os.listdir(build_dir) if p.endswith(".so"))
    assert len(libs) == 1 and libs[0].startswith("libclip_tokenizer_")
    assert not [p for p in os.listdir(build_dir) if p.endswith(".tmp")]
