"""A thread with a stop event, and a lock-guarded counter (counterpart of
``pfrl_tpu/utils/stoppable_thread.py``; reference parity:
pfrl/utils/stoppable_thread.py).

The actor-learner mode of the ``DQN`` shell runs its learner and poller
loops on :class:`StoppableThread` and counts env steps and publications
with :class:`Counter`. Host code only: it imports no torch.
"""

import threading


class StoppableThread(threading.Thread):
    """Thread carrying an event object that asks it to stop.

    Args:
        stop_event: ``threading.Event`` polled by the thread's target; the
            thread's loop should exit when it is set.
    """

    def __init__(self, stop_event: threading.Event, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.stop_event = stop_event

    def stop(self) -> None:
        self.stop_event.set()

    def is_stopped(self) -> bool:
        return self.stop_event.is_set()


class Counter:
    """Thread-shared monotonic counter: the reference's ``mp.Value`` global
    step counter, for actors that are threads of one process."""

    def __init__(self, value: int = 0):
        self._value = value
        self._lock = threading.Lock()

    def increment(self, n: int = 1) -> int:
        """Add ``n`` and return the new value."""
        with self._lock:
            self._value += n
            return self._value

    @property
    def value(self) -> int:
        with self._lock:
            return self._value
