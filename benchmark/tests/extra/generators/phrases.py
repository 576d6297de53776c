"""A generator for the harness's tests only: ``words_min`` to
``words_max`` consecutive words of a title drawn uniformly, every other
query with one letter left out of its last word of 5 letters or more."""

from benchmark.generators import Spec


def queries(made, traffic, n, rng):
    out = []
    for i in range(n):
        words = rng.choice(made.titles).split()
        k = min(len(words), rng.randint(traffic["words_min"],
                                        traffic["words_max"]))
        start = rng.randrange(len(words) - k + 1)
        phrase = words[start:start + k]
        if i % 2 and len(phrase[-1]) >= 5:
            j = rng.randrange(1, len(phrase[-1]) - 1)
            phrase[-1] = phrase[-1][:j] + phrase[-1][j + 1:]
        out.append(Spec(" ".join(phrase)))
    return out
