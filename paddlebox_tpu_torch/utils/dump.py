"""Debug dump workers: per-batch fields and pass-end params into part files.

Port of the JAX package's ``utils/dump.py`` (DeviceWorker::DumpField /
DumpParam, device_worker.cc:98-133, sampled by dump_mode / dump_interval,
device_worker.h:218-219; the trainer's dump threads, TrainerBase::DumpWork
trainer.cc:55-61). Lines are queued on a string channel; N writer threads
drain it into ``part-NNNNN`` files through ``fs_open_write`` and an
optional converter. The line formats and the sampling hash are the JAX
package's, so with one writer the files are the same bytes.

Dump modes (trainer_desc dump_mode):
  0 — dump every instance
  1 — sample by blake2b(ins_id) % interval == 0
  2 — dump batches where step % interval == 0
"""

from __future__ import annotations

import hashlib
import queue
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from paddlebox_tpu_torch.utils.fs import fs_open_write

_STOP = object()


class DumpWorkerPool:
    """N writer threads draining a string channel into part-NNNNN files."""

    def __init__(
        self,
        dump_path: str,
        n_threads: int = 1,
        converter: Optional[str] = None,
        file_prefix: str = "part",
    ):
        self.dump_path = dump_path.rstrip("/")
        self.converter = converter
        self._q: "queue.Queue" = queue.Queue(maxsize=10000)
        self._threads = [threading.Thread(target=self._run, args=(i,), daemon=True) for i in range(n_threads)]
        self._prefix = file_prefix
        self._started = False

    def start(self) -> None:
        for t in self._threads:
            t.start()
        self._started = True

    def write(self, line: str) -> None:
        self._q.put(line)

    def _run(self, tid: int) -> None:
        path = f"{self.dump_path}/{self._prefix}-{tid:05d}"
        with fs_open_write(path, self.converter) as f:
            while True:
                item = self._q.get()
                if item is _STOP:
                    return
                f.write(item + "\n")

    def finalize(self) -> None:
        """Flush and join (FinalizeDumpEnv)."""
        if not self._started:
            return
        for _ in self._threads:
            self._q.put(_STOP)
        for t in self._threads:
            t.join()
        self._started = False


def _want_ins(mode: int, interval: int, ins_id: str, step: int) -> bool:
    if mode == 0:
        return True
    if mode == 1:
        h = int.from_bytes(hashlib.blake2b(ins_id.encode(), digest_size=8).digest(), "little")
        return h % max(1, interval) == 0
    return step % max(1, interval) == 0


def dump_fields(
    pool: DumpWorkerPool,
    ins_ids: Sequence[str],
    fields: Dict[str, np.ndarray],
    step: int = 0,
    dump_mode: int = 0,
    dump_interval: int = 1,
) -> int:
    """One line per kept instance: ``ins_id\\tname:v0,v1,...`` per field,
    each value ``{v:.6g}`` (the DumpField line). Returns the instances
    dumped."""
    rows: List[str] = []
    for i, ins_id in enumerate(ins_ids):
        if not _want_ins(dump_mode, dump_interval, ins_id, step):
            continue
        parts = [ins_id]
        for name, arr in fields.items():
            vals = np.asarray(arr[i]).reshape(-1)
            parts.append(name + ":" + ",".join(f"{v:.6g}" for v in vals))
        rows.append("\t".join(parts))
    for r in rows:
        pool.write(r)
    return len(rows)


def dump_param(pool: DumpWorkerPool, name: str, value: np.ndarray) -> None:
    """One param a line: ``name\\tv0,v1,...`` (the DumpParam line)."""
    flat = np.asarray(value).reshape(-1)
    pool.write(name + "\t" + ",".join(f"{v:.6g}" for v in flat))
