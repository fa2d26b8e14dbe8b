"""Prompt tokenizer for the text encoder (counterpart of
``mhla_tpu/data/tokenizers.py``).

The reference's ``HuggingfaceTokenizer``: an ``AutoTokenizer`` with
max-length padding and an optional cleaning of the text (``whitespace``,
``lower`` or ``canonicalize``). ``transformers`` is imported only when a
tokenizer is built, and raises ``ImportError`` there where it is missing;
``ftfy``, where installed, repairs mojibake first. Returns numpy int32
arrays.
"""

from __future__ import annotations

import html
import re
import string
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

try:  # optional: mojibake repair (the reference's ftfy.fix_text)
    import ftfy

    _fix_text = ftfy.fix_text
except ImportError:
    _fix_text = lambda s: s  # noqa: E731


def basic_clean(text: str) -> str:
    return html.unescape(html.unescape(_fix_text(text))).strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def canonicalize(text: str, keep_punctuation_exact_string: Optional[str] = None) -> str:
    text = text.replace("_", " ")
    table = str.maketrans("", "", string.punctuation)
    if keep_punctuation_exact_string:
        text = keep_punctuation_exact_string.join(
            part.translate(table) for part in text.split(keep_punctuation_exact_string)
        )
    else:
        text = text.translate(table)
    return re.sub(r"\s+", " ", text.lower()).strip()


class PromptTokenizer:
    """Max-length-padded tokenization with the reference's cleaning modes."""

    def __init__(self, name: str, seq_len: Optional[int] = None, clean: Optional[str] = None,
                 **kwargs):
        if clean not in (None, "whitespace", "lower", "canonicalize"):
            raise ValueError(f"clean {clean!r}: None, whitespace, lower or canonicalize")
        try:
            from transformers import AutoTokenizer
        except ImportError as err:
            raise ImportError("PromptTokenizer needs the transformers package") from err

        self.name, self.seq_len, self.clean = name, seq_len, clean
        self.tokenizer = AutoTokenizer.from_pretrained(name, **kwargs)
        self.vocab_size = self.tokenizer.vocab_size

    def _clean(self, text: str) -> str:
        if self.clean == "whitespace":
            return whitespace_clean(basic_clean(text))
        if self.clean == "lower":
            return whitespace_clean(basic_clean(text)).lower()
        if self.clean == "canonicalize":
            return canonicalize(basic_clean(text))
        return text

    def __call__(self, sequence: Union[str, Sequence[str]], return_mask: bool = False,
                 **kwargs) -> Union[np.ndarray, Tuple[np.ndarray, np.ndarray]]:
        if isinstance(sequence, str):
            sequence = [sequence]
        texts: List[str] = [self._clean(u) for u in sequence]
        call_kwargs = {"return_tensors": "np"}
        if self.seq_len is not None:
            call_kwargs.update(padding="max_length", truncation=True, max_length=self.seq_len)
        call_kwargs.update(kwargs)
        out = self.tokenizer(texts, **call_kwargs)
        ids = np.asarray(out["input_ids"], np.int32)
        if return_mask:
            return ids, np.asarray(out["attention_mask"], np.int32)
        return ids
