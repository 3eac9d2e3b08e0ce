#!/usr/bin/env python
"""Regenerate the vendored bAbI graph data (babi_data/), 10 folds
(SURVEY.md §2.1 C11: the reference commits preprocessed data; the mount was
empty, so this repo vendors generator output in the same text format).

Per-task sizes cover the paper protocols: 60 examples per question type for
training (50 used by default configs), 300 for task 19 (250-example
setting), 50 test examples per question type."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from ggnn.data.babi import TASKS
from ggnn.data.generators import generate_task_file


def main(root="babi_data", folds=10, seed=0):
    for fold in range(1, folds + 1):
        for split, per_q, salt in (("train", 60, 0), ("test", 50, 1)):
            d = os.path.join(root, f"processed_{fold}", split)
            os.makedirs(d, exist_ok=True)
            for task_id, spec in TASKS.items():
                n = per_q * spec.n_question_types
                if task_id == 19 and split == "train":
                    n = 300
                text = generate_task_file(
                    task_id, n, seed=hash((seed, fold, salt, task_id)) % (2**31))
                with open(os.path.join(d, f"{task_id}_graphs.txt"), "w") as f:
                    f.write(text)
    print(f"wrote {folds} folds under {root}/")


if __name__ == "__main__":
    main(*sys.argv[1:2])
