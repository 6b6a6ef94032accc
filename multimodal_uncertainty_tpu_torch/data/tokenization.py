"""BERT WordPiece tokenization (port of ``data/tokenization.py``, its own copy).

``pytorch_pretrained_bert.BertTokenizer`` of the MMBT path (reference
``src/dataset.py:462-472,484-486``): basic whitespace / punctuation splitting
with lowercasing and accent stripping, then greedy longest-match WordPiece,
from a local ``vocab.txt``. The JAX package's C++ tokenizer gives the same
tokens; it is not ported.
"""
from __future__ import annotations

import collections
import unicodedata
from typing import Dict, List


def load_vocab(vocab_file: str) -> Dict[str, int]:
    vocab = collections.OrderedDict()
    with open(vocab_file, encoding="utf-8") as f:
        for i, line in enumerate(f):
            tok = line.rstrip("\n")
            if tok:
                vocab[tok] = i
    return vocab


def _is_whitespace(ch):
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch):
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch):
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


class BasicTokenizer:
    def __init__(self, do_lower_case: bool = True):
        self.do_lower_case = do_lower_case

    def tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        text = self._tokenize_chinese_chars(text)
        tokens = text.split()
        out = []
        for tok in tokens:
            if self.do_lower_case:
                tok = tok.lower()
                tok = self._strip_accents(tok)
            out.extend(self._split_punct(tok))
        return " ".join(out).split()

    @staticmethod
    def _is_chinese_char(cp: int) -> bool:
        return (
            (0x4E00 <= cp <= 0x9FFF)
            or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF)
            or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F)
            or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF)
            or (0x2F800 <= cp <= 0x2FA1F)
        )

    def _tokenize_chinese_chars(self, text: str) -> str:
        out = []
        for ch in text:
            if self._is_chinese_char(ord(ch)):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return "".join(out)

    @staticmethod
    def _clean(text):
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(text):
        text = unicodedata.normalize("NFD", text)
        return "".join(ch for ch in text if unicodedata.category(ch) != "Mn")

    @staticmethod
    def _split_punct(text):
        out, cur = [], []
        for ch in text:
            if _is_punctuation(ch):
                if cur:
                    out.append("".join(cur))
                    cur = []
                out.append(ch)
            else:
                cur.append(ch)
        if cur:
            out.append("".join(cur))
        return out


class WordpieceTokenizer:
    def __init__(self, vocab: Dict[str, int], unk_token="[UNK]", max_chars=100):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_chars = max_chars

    def tokenize(self, text: str) -> List[str]:
        out = []
        for token in text.split():
            if len(token) > self.max_chars:
                out.append(self.unk_token)
                continue
            start, pieces, bad = 0, [], False
            while start < len(token):
                end = len(token)
                cur = None
                while start < end:
                    sub = token[start:end]
                    if start > 0:
                        sub = "##" + sub
                    if sub in self.vocab:
                        cur = sub
                        break
                    end -= 1
                if cur is None:
                    bad = True
                    break
                pieces.append(cur)
                start = end
            out.extend([self.unk_token] if bad else pieces)
        return out


class BertTokenizer:
    """tokenize(text) -> wordpiece list; convert ids via ``vocab``."""

    def __init__(self, vocab_file: str, do_lower_case: bool = True):
        self.vocab = load_vocab(vocab_file)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.basic = BasicTokenizer(do_lower_case)
        self.wordpiece = WordpieceTokenizer(self.vocab)

    def tokenize(self, text: str) -> List[str]:
        out = []
        for tok in self.basic.tokenize(text):
            out.extend(self.wordpiece.tokenize(tok))
        return out

    def convert_tokens_to_ids(self, tokens: List[str]) -> List[int]:
        unk = self.vocab.get("[UNK]", 0)
        return [self.vocab.get(t, unk) for t in tokens]


class Vocab:
    """Reference ``Vocab`` (``src/dataset.py:440-460``)."""

    def __init__(self, empty_init: bool = False):
        if empty_init:
            self.stoi, self.itos, self.vocab_sz = {}, [], 0
        else:
            self.stoi = {
                w: i
                for i, w in enumerate(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"])
            }
            self.itos = list(self.stoi)
            self.vocab_sz = len(self.itos)

    def add(self, words):
        cnt = len(self.itos)
        for w in words:
            if w in self.stoi:
                continue
            self.stoi[w] = cnt
            self.itos.append(w)
            cnt += 1
        self.vocab_sz = len(self.itos)


def get_vocab(vocab_file: str) -> Vocab:
    """Reference ``get_vocab`` (``src/dataset.py:462-472``) from a local
    vocab.txt."""
    tok = BertTokenizer(vocab_file)
    vocab = Vocab(empty_init=True)
    vocab.stoi = dict(tok.vocab)
    vocab.itos = [t for t, _ in sorted(tok.vocab.items(), key=lambda kv: kv[1])]
    vocab.vocab_sz = len(vocab.itos)
    return vocab
