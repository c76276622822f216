"""Llama tokenizers with one call, ``tokenizer(text, add_bos, add_eos)``
(counterpart of ``quantized_training_tpu/data/tokenizers.py``, a copy).

- ``llama2``: a SentencePiece model (``sentencepiece`` is imported when one
  is made, and raises a clear error where it is not installed);
- ``llama3``: tiktoken BPE with the Llama-3 pattern and special tokens
  (``tiktoken`` imported when one is made);
- ``byte``: UTF-8 bytes with bos/eos/pad at 256/257/258, no dependency; for
  tests and offline runs.

Model files resolve from a path or ``$TOKENIZER_DIR`` (default
``tokenizers/``); nothing is downloaded.
"""

from __future__ import annotations

import os
from pathlib import Path


def get_tokenizer(name: str, model_path: str | None = None):
    return {
        "llama2": Llama2Tokenizer,
        "llama3": Llama3Tokenizer,
        "byte": ByteTokenizer,
    }[name](model_path)


def _resolve(model_path: str | None, default_name: str) -> str:
    if model_path and Path(model_path).exists():
        return model_path
    cand = Path(os.environ.get("TOKENIZER_DIR", "tokenizers")) / default_name
    if cand.exists():
        return str(cand)
    raise FileNotFoundError(
        f"tokenizer model not found (looked for {model_path or cand}); "
        "set TOKENIZER_DIR or pass model_path"
    )


class Llama2Tokenizer:
    bos_id = 1
    eos_id = 2
    pad_id = 0

    def __init__(self, model_path: str | None = None):
        try:
            import sentencepiece as spm
        except ImportError as e:
            raise ImportError(
                "llama2 tokenizer needs sentencepiece, which is not installed "
                "here; use tokenizer='llama3' or 'byte'"
            ) from e
        self.tokenizer = spm.SentencePieceProcessor(
            _resolve(model_path, "llama2.model")
        )

    def __call__(self, text: str, add_bos: bool = False, add_eos: bool = False):
        return self.tokenizer.Encode(text, add_bos=add_bos, add_eos=add_eos)

    def decode(self, tokens: list[int]) -> str:
        return self.tokenizer.Decode(tokens)

    @property
    def vocab_size(self) -> int:
        return self.tokenizer.vocab_size()


class Llama3Tokenizer:
    bos_id = 128_000
    eos_id = 128_001
    pad_id = 128_004

    def __init__(self, model_path: str | None = None):
        import tiktoken
        from tiktoken.load import load_tiktoken_bpe

        pat_str = r"""(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"""
        self.tokenizer = tiktoken.Encoding(
            "llama3",
            pat_str=pat_str,
            mergeable_ranks=load_tiktoken_bpe(_resolve(model_path, "llama3.model")),
            special_tokens={
                "<|begin_of_text|>": 128000,
                "<|end_of_text|>": 128001,
                "<|finetune_right_pad_id|>": 128004,
            },
        )

    def __call__(self, text: str, add_bos: bool = False, add_eos: bool = False):
        tokens = []
        if add_bos:
            tokens.append(self.bos_id)
        tokens.extend(self.tokenizer.encode(text, disallowed_special=()))
        if add_eos:
            tokens.append(self.eos_id)
        return tokens

    def decode(self, tokens: list[int]) -> str:
        return self.tokenizer.decode(tokens)

    @property
    def vocab_size(self) -> int:
        return self.tokenizer.max_token_value + 1


class ByteTokenizer:
    """UTF-8 bytes + 256=bos, 257=eos, 258=pad. For tests/offline runs."""

    bos_id = 256
    eos_id = 257
    pad_id = 258

    def __init__(self, model_path: str | None = None):
        del model_path

    def __call__(self, text: str, add_bos: bool = False, add_eos: bool = False):
        tokens = list(text.encode("utf-8"))
        if add_bos:
            tokens.insert(0, self.bos_id)
        if add_eos:
            tokens.append(self.eos_id)
        return tokens

    def decode(self, tokens: list[int]) -> str:
        return bytes(t for t in tokens if t < 256).decode("utf-8", errors="replace")

    @property
    def vocab_size(self) -> int:
        return 259
