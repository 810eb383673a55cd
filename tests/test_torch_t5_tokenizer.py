"""The port's T5 tokenizer (``utils/t5_tokenizer.py``) against
``transformers.T5TokenizerFast`` and the JAX package's ``tokenize_2``.

The vocabulary is ``chip_smoke.T5_TINY_PIECES`` (a Unigram model of a few
dozen pieces), built offline three ways: with the installed ``tokenizers``
and saved by ``T5TokenizerFast.save_pretrained``; as the ``tokenizer.json``
``chip_smoke.write_t5_tokenizer`` writes by hand (what the card's smoke
and the JAX-free test use); and as a hand-built SentencePiece
``spiece.model`` protobuf. The ids and padding masks at 77 tokens must be
equal on prompts that truncate (``</s>`` kept last), are empty, non-ASCII
(NFKC folds full-width letters), hold repeated, leading and trailing
spaces, unknown characters (fused into one ``<unk>``) and a ``</s>`` in the
text. ``tokenize_2`` of a pipeline built by the port's loader equals the
JAX pipeline's over ``AutoTokenizer``, and a text request through the
loader equals the same request by ids (``chip_smoke.phase_t5_text`` on the
CPU).
"""

import json
import struct
import types

import numpy as np
import pytest
import torch

import chip_smoke
from followyourclick_tpu.pipelines.animation import (
    AnimationPipeline as JPipeline,
)
from followyourclick_tpu_torch.pipelines.animation import AnimationPipeline
from followyourclick_tpu_torch.utils.t5_tokenizer import T5Tokenizer
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401

PROMPTS = [
    "a red car drives on the road",
    "",
    "  the   cat  ",
    " a blue dog",
    "a é x zz and ü",
    "ｔｈｅ ｃａｒ",          # full-width: NFKC folds it
    "the sun " * 60,           # truncated at 77 with </s> last
    "a cat</s>the dog",
    "xyz\tthe  \t road",
]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """{"hf": saved by T5TokenizerFast, "hand": chip_smoke's JSON,
    "spiece": the protobuf}."""
    from tokenizers import (
        Regex,
        Tokenizer,
        decoders,
        models,
        normalizers,
        pre_tokenizers,
        processors,
    )
    from transformers import T5TokenizerFast

    root = tmp_path_factory.mktemp("t5tok")
    tok = Tokenizer(models.Unigram(chip_smoke.T5_TINY_PIECES, unk_id=2,
                                   byte_fallback=False))
    tok.normalizer = normalizers.Sequence([
        normalizers.NFKC(), normalizers.Strip(left=False, right=True),
        normalizers.Replace(Regex(" {2,}"), "▁")])
    tok.pre_tokenizer = pre_tokenizers.Metaspace(
        replacement="▁", prepend_scheme="always", split=True)
    tok.post_processor = processors.TemplateProcessing(
        single="$A </s>", pair="$A </s> $B </s>",
        special_tokens=[("</s>", 1)])
    tok.decoder = decoders.Metaspace(replacement="▁",
                                     prepend_scheme="always", split=True)
    T5TokenizerFast(tokenizer_object=tok, eos_token="</s>",
                    unk_token="<unk>", pad_token="<pad>",
                    extra_ids=0).save_pretrained(str(root / "hf"))
    chip_smoke.write_t5_tokenizer(str(root / "hand"))
    (root / "spiece").mkdir()
    write_spiece_model(root / "spiece" / "spiece.model",
                       chip_smoke.T5_TINY_PIECES)
    return {k: str(root / k) for k in ("hf", "hand", "spiece")}


def _varint(n):
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(number, wire, payload):
    key = _varint(number << 3 | wire)
    if wire == 2:
        return key + _varint(len(payload)) + payload
    return key + payload


def write_spiece_model(path, pieces):
    """A SentencePiece ``ModelProto``: each piece (string, fp32 score,
    type: CONTROL for <pad> and </s>, UNKNOWN for <unk>), the normalizer
    spec ``nmt_nfkc`` with a dummy prefix and extra whitespace removed."""
    types_ = {"<pad>": 3, "</s>": 3, "<unk>": 2}
    body = b""
    for piece, score in pieces:
        body += _field(1, 2, _field(1, 2, piece.encode())
                       + _field(2, 5, struct.pack("<f", score))
                       + _field(3, 0, _varint(types_.get(piece, 1))))
    body += _field(3, 2, _field(1, 2, b"nmt_nfkc") + _field(3, 0, b"\x01")
                   + _field(4, 0, b"\x01"))
    with open(path, "wb") as f:
        f.write(body)


def _hf(path):
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(path)


def _encode(tok, prompts):
    enc = tok(list(prompts), padding="max_length", max_length=77,
              truncation=True, return_tensors="np")
    return np.asarray(enc.input_ids), np.asarray(enc.attention_mask)


@pytest.mark.parametrize("source", ["hf", "hand"])
def test_ids_equal_t5_tokenizer_fast(dirs, source):
    want = _encode(_hf(dirs["hf"]), PROMPTS)
    port = T5Tokenizer.from_pretrained(dirs[source])
    got = _encode(port, PROMPTS)
    for g, w in zip(got, want):
        assert g.dtype == np.int64 and g.shape == (len(PROMPTS), 77)
        np.testing.assert_array_equal(g, w)
    # the hand-written file reads the same in transformers
    for g, w in zip(_encode(_hf(dirs["hand"]), PROMPTS), want):
        np.testing.assert_array_equal(g, w)
    assert got[0][6, -1] == 1 and got[1][6].all()      # truncated, </s> last
    assert got[0][1, 0] == 1 and got[1][1].sum() == 1  # empty: </s> alone


def test_spiece_model_gives_the_same_ids(dirs):
    prompts = [p for p in PROMPTS if "</s>" not in p]  # no added tokens
    want = _encode(T5Tokenizer.from_pretrained(dirs["hand"]), prompts)
    got = _encode(T5Tokenizer.from_pretrained(dirs["spiece"]), prompts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_jax_tokenize_2_equals_the_ports(dirs):
    """The JAX pipeline's ``tokenize_2`` over the ``AutoTokenizer`` its
    loader builds, against the port pipeline's over its own tokenizer."""
    negatives = ["ugly, blurry"] * (len(PROMPTS) - 1) + [""]
    want = JPipeline.tokenize_2(types.SimpleNamespace(
        tokenizer_2=_hf(dirs["hand"])), PROMPTS, negatives)
    got = AnimationPipeline.tokenize_2(types.SimpleNamespace(
        tokenizer_2=T5Tokenizer.from_pretrained(dirs["hand"])), PROMPTS,
        negatives)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    ids = got[0][0]
    n = len(chip_smoke.T5_TEXT_IDS)
    assert PROMPTS[0] == chip_smoke.T5_TEXT_PROMPT
    assert ids[:n].tolist() == chip_smoke.T5_TEXT_IDS and not ids[n:].any()


def test_legacy_whitespace_split_pre_tokenizer(dirs, tmp_path):
    """The older T5 ``tokenizer.json`` layout (``WhitespaceSplit`` then a
    ``Metaspace`` with ``add_prefix_space``), against ``tokenizers``."""
    from tokenizers import Tokenizer

    with open(f"{dirs['hand']}/tokenizer.json", encoding="utf-8") as f:
        spec = json.load(f)
    spec["normalizer"] = {"type": "NFKC"}
    spec["pre_tokenizer"] = {"type": "Sequence", "pretokenizers": [
        {"type": "WhitespaceSplit"},
        {"type": "Metaspace", "replacement": "▁", "add_prefix_space": True}]}
    path = tmp_path / "tokenizer.json"
    path.write_text(json.dumps(spec, ensure_ascii=False), encoding="utf-8")
    want = Tokenizer.from_file(str(path))
    port = T5Tokenizer.from_pretrained(str(path))
    for prompt in PROMPTS:
        assert port.encode(prompt) == want.encode(
            prompt, add_special_tokens=False).ids, prompt


def test_precompiled_normalizer_is_nfkc_and_bad_files_raise(dirs, tmp_path):
    from followyourclick_tpu_torch.utils.t5_tokenizer import _normalizer

    assert _normalizer({"type": "Precompiled",
                        "precompiled_charsmap": ""})("ｔｈｅ ①") == "the 1"
    with pytest.raises(ValueError, match="normalizer"):
        _normalizer({"type": "BertNormalizer"})
    spec = json.loads(open(f"{dirs['hand']}/tokenizer.json",
                           encoding="utf-8").read())
    spec["model"]["type"] = "BPE"
    (tmp_path / "tokenizer.json").write_text(json.dumps(spec))
    with pytest.raises(ValueError, match="Unigram"):
        T5Tokenizer.from_pretrained(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        T5Tokenizer.from_pretrained(str(tmp_path / "none"))
    port = T5Tokenizer.from_pretrained(dirs["hand"])
    with pytest.raises(ValueError, match="max_length"):
        port(["the sun " * 60], truncation=False)


def test_text_request_through_the_loader(tmp_path):
    """A tiny SD directory and a T5 directory with ``tokenizer.json``
    through ``assemble_pipeline_from_pretrained``: the T5 tokenizer is
    built, the prompt's ids are ``T5_TEXT_IDS``, the text request equals
    the ids request and other T5 ids move the video."""
    got = chip_smoke.phase_t5_text(0, str(tmp_path), device="cpu")
    assert set(got) >= set(chip_smoke.KERNELS)
    # without a tokenizer file the loader leaves tokenizer_2 None, as JAX
    from followyourclick_tpu_torch.utils.loaders import (
        assemble_pipeline_from_pretrained,
    )

    t5 = tmp_path / "t5_tiny"
    for name in ("tokenizer.json", "tokenizer_config.json"):
        (t5 / name).unlink()
    base = chip_smoke.tiny_config()
    pipe = assemble_pipeline_from_pretrained(
        str(tmp_path / "sd_tiny"), base, t5_path=str(t5),
        dtype=torch.float32, device="cpu")
    assert pipe.tokenizer_2 is None and pipe.t5 is not None
