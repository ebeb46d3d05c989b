"""Experiment logging (counterpart of `mlsp_tpu/utils/logging.py`):
timestamped stdout and `run.log`, per-epoch `metrics.jsonl`, confusion
matrices as CSV. Only process 0 writes the experiment's files; another
rank of an initialised `torch.distributed` group prints, prefixed.
"""

from __future__ import annotations

import csv
import datetime
import json
import os

from mlsp_tpu_torch.utils.device import process_index


class IOStream:
    """The experiment directory `{out_path}/{exp_name}` and its files."""

    def __init__(self, out_path: str, exp_name: str):
        self.path = os.path.join(out_path, exp_name)
        self._rank = process_index()
        self.primary = self._rank == 0
        self._f = None
        if self.primary:
            os.makedirs(self.path, exist_ok=True)
            self._f = open(os.path.join(self.path, "run.log"), "a")

    def cprint(self, text: str) -> None:
        stamp = datetime.datetime.now().strftime("%d-%m-%y %H:%M:%S")
        prefix = "" if self.primary else f"[rank {self._rank}] "
        line = f"{stamp}: {prefix}{text}"
        print(line, flush=True)
        if self._f is not None:
            self._f.write(line + "\n")
            self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def print_progress(self, domain_set, partition, epoch, print_losses,
                       true=None, pred=None) -> float:
        """Print an epoch progress line; returns the accuracy when labels
        are given."""
        from mlsp_tpu_torch.utils import metrics as M

        out = f"{partition} - {domain_set} {epoch}"
        acc = 0.0
        if true is not None and pred is not None:
            acc = M.accuracy(true, pred)
            bal = M.balanced_accuracy(true, pred)
            out += f", acc: {acc:.4f}, avg acc: {bal:.4f}"
        if print_losses is not None:
            for k, v in print_losses.items():
                out += f", {k} loss: {v:.4f}"
        self.cprint(out)
        return acc

    def log_metrics(self, record: dict, fname: str = "metrics.jsonl") -> None:
        """Append one JSON line to `{exp_dir}/{fname}` (numpy values
        converted, nested dicts kept)."""
        def conv(v):
            if isinstance(v, dict):
                return {k: conv(x) for k, x in v.items()}
            if hasattr(v, "tolist"):
                return v.tolist()
            return v

        if not self.primary:
            return
        with open(os.path.join(self.path, fname), "a") as f:
            f.write(json.dumps(conv(record)) + "\n")

    def trim_metrics(self, below: int, key: str = "epoch",
                     fname: str = "metrics.jsonl") -> None:
        """Keep only the records with `record[key] < below`: a fresh run
        in a reused directory empties the file (below=0), a resumed run
        drops the records its epochs will write again."""
        path = os.path.join(self.path, fname)
        if not self.primary or not os.path.exists(path):
            return
        kept = []
        with open(path) as f:
            for line in f:
                try:
                    if json.loads(line).get(key, below) < below:
                        kept.append(line)
                except json.JSONDecodeError:
                    pass
        with open(path, "w") as f:
            f.writelines(kept)

    def save_conf_mat(self, conf_matrix, fname: str, domain_set: str,
                      class_names=None) -> None:
        if not self.primary:
            return
        names = class_names or [str(i) for i in range(conf_matrix.shape[0])]
        with open(os.path.join(self.path, f"{domain_set}_{fname}"), "w",
                  newline="") as f:
            w = csv.writer(f)
            w.writerow([""] + list(names))
            for name, row in zip(names, conf_matrix):
                w.writerow([name] + list(map(int, row)))
