"""Train-state snapshots written on a background thread (the counterpart of
morphganformer_tpu/checkpoint/orbax_io.py).

The JAX package hands its train state to Orbax's AsyncCheckpointer so that
a snapshot does not stall the step loop. Here the caller copies the state
to the host (`training/loop.py::train_state_tree`, synchronous, so training
may go on changing the tensors), and `save` serialises it and writes
`<snapshot>/train_state.msgpack` on a thread: the same file the synchronous
path writes. At most one save is in flight; a failed write is raised by the
next `save`, `wait`, `restore` or `close`. Selected with
`LoopConfig(snapshot_backend="async")`.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

from morphganformer_tpu_torch.checkpoint.msgpack_codec import msgpack_restore, msgpack_serialize

TRAIN_STATE_FILE = "train_state.msgpack"


def write_tree(path: str, tree) -> None:
    """Serialise `tree` to `path` through a temporary file, so the name
    holds either nothing or the whole file."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(msgpack_serialize(tree))
    os.replace(tmp, path)


class AsyncSnapshotter:
    """Background writer of train-state trees (one outstanding save)."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, path: str, tree) -> None:
        """Start writing the host tree `tree` to `path`/train_state.msgpack;
        waits for the previous save first."""
        self.wait()

        def run():
            try:
                write_tree(os.path.join(path, TRAIN_STATE_FILE), tree)
            except BaseException as e:      # raised to the caller by wait()
                self._error = e

        self._thread = threading.Thread(target=run, name="snapshot-writer", daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def restore(self, path: str):
        """The tree saved under snapshot `path` (after any save in flight)."""
        self.wait()
        with open(os.path.join(path, TRAIN_STATE_FILE), "rb") as f:
            return msgpack_restore(f.read())

    def close(self) -> None:
        self.wait()
