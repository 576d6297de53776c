"""A deployment for the harness's tests only: titles of ``words_min`` to
``words_max`` invented words (letters drawn uniformly, 3-9 of them), each
word drawn uniformly from a vocabulary of ``vocab_words``. It reuses the
titles deployment's engine and reference: one text field under
``SearchEngine.create_default()``."""

import random
from types import SimpleNamespace

from benchmark.deployments import titles

LETTERS = "aeioulnrstdkmpbg"


def documents(config, seed):
    spec = config["corpus"]
    rng = random.Random(f"words:{seed}")
    vocab = set()
    while len(vocab) < spec["vocab_words"]:
        vocab.add("".join(rng.choice(LETTERS)
                          for _ in range(rng.randint(3, 9))))
    vocab = sorted(vocab)
    made = [" ".join(rng.choice(vocab) for _ in range(
        rng.randint(spec["words_min"], spec["words_max"]))).capitalize()
        for _ in range(spec["titles"])]
    return SimpleNamespace(titles=made)


engine = titles.engine
reference = titles.reference
judge = titles.judge
