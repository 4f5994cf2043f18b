"""The heaviest card's march kernel time over the mean of the cards', per
frame, averaged over the window's frames (1.0 is an even deal). Frame k's
record on a card is that card's k-th march kernel record."""

from harness.readers import MARCH


def read(rec):
    per_card = [[e - s for name, _, s, e, _ in evs if MARCH.search(name)]
                for evs in rec["trace"]["device"].values()]
    if len(per_card) < 2:
        return None
    frames = min(len(c) for c in per_card)
    if frames == 0:
        return None
    ratios = []
    for k in range(frames):
        t = [c[k] for c in per_card]
        ratios.append(max(t) / (sum(t) / len(t)))
    return sum(ratios) / len(ratios)
