"""Text datasets (port of paddle_tpu/text/datasets.py; reference:
python/paddle/text/datasets/). Numpy only, as in the JAX package: each
class reads a local file when one is given (Imdb, UCIHousing, Imikolov)
or makes the JAX package's synthetic data from the same numpy seeds, so
items are bitwise the JAX package's. Nothing is downloaded. Movielens,
Conll05st, WMT14 and WMT16 have no real-corpus loader in the reference
either (`_no_real_loader` refuses a data_file)."""
from __future__ import annotations

import os
import re
import tarfile

import numpy as np

from ..io import Dataset

__all__ = ["Imdb", "UCIHousing", "Imikolov", "Movielens", "Conll05st",
           "WMT14", "WMT16"]


class Imdb(Dataset):
    def __init__(self, data_file=None, mode="train", cutoff=150):
        self.mode = mode
        if data_file and os.path.exists(data_file):
            self._load_real(data_file, mode, cutoff)
        else:
            rng = np.random.RandomState(0 if mode == "train" else 1)
            n, vocab = 512, 5000
            self.docs = [rng.randint(2, vocab, rng.randint(20, 100))
                         for _ in range(n)]
            self.labels = rng.randint(0, 2, n).astype(np.int64)
            self.word_idx = {f"w{i}": i for i in range(vocab)}

    def _load_real(self, data_file, mode, cutoff):
        pat = re.compile(rf"aclImdb/{mode}/(pos|neg)/.*\.txt$")
        freq = {}
        docs, labels = [], []
        with tarfile.open(data_file) as tf:
            for member in tf.getmembers():
                m = pat.match(member.name)
                if not m:
                    continue
                text = tf.extractfile(member).read().decode(
                    "latin-1").lower().split()
                docs.append(text)
                labels.append(1 if m.group(1) == "pos" else 0)
                for w in text:
                    freq[w] = freq.get(w, 0) + 1
        words = sorted(freq, key=lambda w: -freq[w])[:cutoff]
        self.word_idx = {w: i + 2 for i, w in enumerate(words)}
        self.docs = [np.asarray([self.word_idx.get(w, 1) for w in d],
                                np.int64) for d in docs]
        self.labels = np.asarray(labels, np.int64)

    def __getitem__(self, idx):
        return self.docs[idx], self.labels[idx]

    def __len__(self):
        return len(self.docs)


class UCIHousing(Dataset):
    FEATURES = 13

    def __init__(self, data_file=None, mode="train"):
        if data_file and os.path.exists(data_file):
            raw = np.loadtxt(data_file).astype(np.float32)
        else:
            rng = np.random.RandomState(0)
            X = rng.randn(506, self.FEATURES).astype(np.float32)
            w = rng.randn(self.FEATURES).astype(np.float32)
            y = X @ w + rng.randn(506).astype(np.float32) * 0.1
            raw = np.concatenate([X, y[:, None]], axis=1)
        split = int(len(raw) * 0.8)
        self.data = raw[:split] if mode == "train" else raw[split:]

    def __getitem__(self, idx):
        row = self.data[idx]
        return row[:-1], row[-1:]

    def __len__(self):
        return len(self.data)


def _no_real_loader(cls_name, data_file):
    if data_file:
        raise NotImplementedError(
            f"{cls_name}: loading a real corpus from {data_file!r} is not "
            "implemented in this build (zero-egress environment ships "
            "synthetic fallbacks); pass data_file=None for synthetic data "
            "or preprocess the corpus into the slot-file format for "
            "io.InMemoryDataset.")


class Imikolov(Dataset):
    """reference: text/datasets/imikolov.py — PTB-style n-gram/seq pairs.
    Local-file loading with synthetic fallback (zero egress)."""

    BOS, EOS = 0, 1

    def __init__(self, data_file=None, data_type="NGRAM", window_size=5,
                 mode="train", min_word_freq=50):
        if data_type not in ("NGRAM", "SEQ"):
            raise ValueError("data_type must be 'NGRAM' or 'SEQ'")
        self.data_type = data_type
        self.window_size = window_size
        if data_file:
            if not os.path.exists(data_file):
                raise FileNotFoundError(
                    f"Imikolov: data_file {data_file!r} does not exist "
                    "(pass None for the synthetic fallback)")
            self._load_real(data_file, mode, min_word_freq)
        else:
            rng = np.random.RandomState(0 if mode == "train" else 1)
            vocab = 2000
            self.word_idx = {f"w{i}": i for i in range(vocab)}
            stream = rng.randint(2, vocab, 20000)
            if data_type == "SEQ":
                # variable-length [BOS, ..., EOS] sequences
                self.data = []
                i = 0
                while i < len(stream) - 2:
                    ln = int(rng.randint(3, 12))
                    seq = stream[i:i + ln]
                    self.data.append(tuple([self.BOS, *seq, self.EOS]))
                    i += ln
            else:
                # mirror the real reader: pseudo-lines wrapped in <s>/<e>
                # before the n-gram window (reference builds n-grams over
                # ['<s>'] + line + ['<e>'])
                self.data = []
                i = 0
                while i < len(stream):
                    ln = int(rng.randint(3, 12))
                    ids = [self.BOS, *stream[i:i + ln], self.EOS]
                    for j in range(0, max(len(ids) - window_size + 1, 0)):
                        self.data.append(tuple(ids[j:j + window_size]))
                    i += ln

    def _load_real(self, data_file, mode, min_word_freq):
        sub = "train" if mode == "train" else "valid"
        freq = {}
        lines = []
        with tarfile.open(data_file) as tf:
            for m in tf.getmembers():
                if f"ptb.{sub}.txt" in m.name:
                    lines = tf.extractfile(m).read().decode().splitlines()
        for ln in lines:
            for w in ln.split():
                freq[w] = freq.get(w, 0) + 1
        # specials live IN word_idx (reference includes '<unk>' too), so
        # Embedding(len(ds.word_idx)) covers every emitted id; PTB corpora
        # contain a literal '<unk>' token — exclude specials from the
        # frequency ranking so ids stay dense and in-range
        specials = ("<s>", "<e>", "<unk>")
        words = [w for w, c in sorted(freq.items(), key=lambda kv: -kv[1])
                 if c >= min_word_freq and w not in specials]
        self.word_idx = {"<s>": 0, "<e>": 1}
        for i, w in enumerate(words):
            self.word_idx[w] = i + 2
        unk = len(self.word_idx)
        self.word_idx["<unk>"] = unk
        self.data = []
        for ln in lines:
            ids = [self.word_idx.get(w, unk) for w in ln.split()]
            if self.data_type == "SEQ":
                if ids:
                    self.data.append(tuple([self.BOS, *ids, self.EOS]))
                continue
            # reference reader builds n-grams over ['<s>'] + line + ['<e>'],
            # so boundary tokens participate and short lines still emit
            ids = [self.BOS, *ids, self.EOS]
            # +1: a line of exactly window_size tokens yields one n-gram
            for i in range(0, max(len(ids) - self.window_size + 1, 0)):
                self.data.append(tuple(ids[i:i + self.window_size]))

    def __getitem__(self, idx):
        if self.data_type == "SEQ":
            return np.asarray(self.data[idx], np.int64)
        return tuple(np.asarray(v, np.int64) for v in self.data[idx])

    def __len__(self):
        return len(self.data)


class Movielens(Dataset):
    """reference: text/datasets/movielens.py — (user, movie, rating)
    records with categorical features (synthetic fallback)."""

    def __init__(self, data_file=None, mode="train", test_ratio=0.1,
                 rand_seed=0):
        _no_real_loader("Movielens", data_file)
        rng = np.random.RandomState(rand_seed)
        n_users, n_movies = 500, 1000
        n = 8000
        users = rng.randint(0, n_users, n)
        movies = rng.randint(0, n_movies, n)
        # learnable structure: rating correlates with (user+movie) parity
        ratings = (1 + (users + movies) % 5).astype(np.float32)
        split = int(n * (1 - test_ratio))
        sl = slice(0, split) if mode == "train" else slice(split, n)
        self.data = list(zip(users[sl], movies[sl], ratings[sl]))

    def __getitem__(self, idx):
        u, m, r = self.data[idx]
        return (np.asarray([u], np.int64), np.asarray([m], np.int64),
                np.asarray([r], np.float32))

    def __len__(self):
        return len(self.data)


class Conll05st(Dataset):
    """reference: text/datasets/conll05.py — SRL: (tokens, predicate,
    labels) triples (synthetic fallback with consistent tag structure)."""

    LABELS = 59  # reference label dict size

    def __init__(self, data_file=None, word_dict_file=None,
                 verb_dict_file=None, target_dict_file=None, mode="train"):
        _no_real_loader("Conll05st", data_file)
        rng = np.random.RandomState(0 if mode == "train" else 1)
        vocab, n = 3000, 512
        self.word_dict = {f"w{i}": i for i in range(vocab)}
        self.label_dict = {f"tag{i}": i for i in range(self.LABELS)}
        self.data = []
        for _ in range(n):
            ln = rng.randint(5, 30)
            words = rng.randint(0, vocab, ln)
            pred = rng.randint(0, ln)
            labels = rng.randint(0, self.LABELS, ln)
            self.data.append((words, pred, labels))

    def get_dict(self):
        return self.word_dict, {0: 0}, self.label_dict

    def __getitem__(self, idx):
        words, pred, labels = self.data[idx]
        return (np.asarray(words, np.int64), np.asarray([pred], np.int64),
                np.asarray(labels, np.int64))

    def __len__(self):
        return len(self.data)


class WMT14(Dataset):
    """reference: text/datasets/wmt14.py — (src_ids, trg_ids, trg_next)
    translation triples (synthetic fallback)."""

    BOS, EOS, UNK = 0, 1, 2

    def __init__(self, data_file=None, mode="train", dict_size=3000):
        _no_real_loader(type(self).__name__, data_file)
        rng = np.random.RandomState(0 if mode == "train" else 1)
        self.dict_size = max(int(dict_size), 10)
        n = 512
        self.data = []
        for _ in range(n):
            ln = rng.randint(4, 20)
            src = rng.randint(3, self.dict_size, ln)
            trg = (src[::-1] % (self.dict_size - 3)) + 3  # learnable rule
            self.data.append((src,
                              np.concatenate([[self.BOS], trg]),
                              np.concatenate([trg, [self.EOS]])))

    def get_dict(self, lang="en", reverse=False):
        d = {f"tok{i}": i for i in range(self.dict_size)}
        return {v: k for k, v in d.items()} if reverse else d

    def __getitem__(self, idx):
        s, t, tn = self.data[idx]
        return (np.asarray(s, np.int64), np.asarray(t, np.int64),
                np.asarray(tn, np.int64))

    def __len__(self):
        return len(self.data)


class WMT16(WMT14):
    """reference: text/datasets/wmt16.py — same triple shape, subword
    vocab (synthetic fallback shares the WMT14 generator)."""

    def __init__(self, data_file=None, mode="train", src_dict_size=3000,
                 trg_dict_size=3000, lang="en"):
        super().__init__(data_file, mode, max(src_dict_size, trg_dict_size))
