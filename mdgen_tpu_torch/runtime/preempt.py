"""Graceful stop on SIGTERM or a ``STOP`` sentinel: the port's own copy of
``mdgen_tpu/runtime/preempt.py`` (os and signal only; held to the original
by ``tests/test_torch_selfcontained.py``).

A ``GracefulStop`` watcher turns either a SIGTERM (a preemptible machine is
told shortly before eviction) or a ``STOP`` sentinel file in the run's
model dir into a clean end-of-step exit: the loop saves a final,
step-tagged checkpoint and returns. ``GracefulStop.clear_sentinel``
compares the sentinel's mtime with the run's ``step_*`` directories, the
layout of ``runtime/checkpoint.py``.
"""
import os
import signal


class GracefulStop:
    """Watch for SIGTERM or a sentinel file; poll from the train loop.

    The signal handler only flips a flag (no I/O, no device calls), so it is
    async-signal-safe and never interrupts an in-flight device call.
    """

    def __init__(self, sentinel_path=None, install_signal=True):
        self.sentinel_path = sentinel_path
        self._flag = False
        self._prev_handler = None
        if install_signal:
            self._prev_handler = signal.signal(signal.SIGTERM, self._on_signal)

    def _on_signal(self, signum, frame):
        self._flag = True

    def clear_sentinel(self, ckpt_dir=None):
        """Remove a stale STOP file (call at trainer startup).

        Without this a sentinel committed by a previous graceful stop
        latches forever: any resumed run in the same model dir would stop
        again within one poll interval and exit 0 looking like success.

        With ``ckpt_dir``, only a *consumed* sentinel is removed: one older
        than the newest ``step_*`` checkpoint in the dir (the previous run's
        stop path saves AFTER seeing the sentinel, so ckpt newer than STOP
        means that stop completed). A sentinel newer than every checkpoint
        (or in a checkpoint-less dir) is a pre-queued stop request for THIS
        run and is honored, not discarded. Returns True if removed.
        """
        if not (self.sentinel_path and os.path.exists(self.sentinel_path)):
            return False
        if ckpt_dir is not None:
            newest = max(
                (
                    os.path.getmtime(os.path.join(ckpt_dir, d))
                    for d in os.listdir(ckpt_dir)
                    if d.startswith("step_")
                    and d.split("_", 1)[1].isdigit()
                ),
                default=None,
            )
            if newest is None or newest < os.path.getmtime(self.sentinel_path):
                return False  # pre-queued stop: leave it latched
        os.remove(self.sentinel_path)
        return True

    def poll(self):
        """True once a stop has been requested (signal or sentinel)."""
        if not self._flag and self.sentinel_path:
            if os.path.exists(self.sentinel_path):
                self._flag = True
        return self._flag

    def close(self):
        """Restore the previous SIGTERM handler (for tests)."""
        if self._prev_handler is not None:
            signal.signal(signal.SIGTERM, self._prev_handler)
            self._prev_handler = None
