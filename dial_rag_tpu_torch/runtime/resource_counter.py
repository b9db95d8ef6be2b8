"""Token-weighted FIFO admission gate.

Same admission contract as the reference's ResourceCounter
(reference resources/resource_counter.py): ``acquire(n)`` debits n
units at once; FIFO order is strict — a large waiter at the head
blocks smaller latecomers (intentional fairness, so big requests
can't starve); one ``release`` admits as many queued waiters as now
fit. The mechanism is this codebase's own: waiters queue as
``(units, future)`` tickets and a single ``_admit`` sweep pops
granted tickets off the head, debiting units at grant time. A ticket
cancelled before its grant just stays in the queue until the sweep
reaches and discards it; one cancelled after its grant refunds the
debit. Both cases re-run the sweep so freed capacity is never
stranded (the deadlock class asyncio.Semaphore also guards against).

Used to bound concurrent remote-model calls by the user's
minute-token budget (runtime/limited.py).
"""

import asyncio
from collections import deque
from typing import Coroutine


class ResourceCounter:
    """FIFO weighted admission over a fixed budget of ``total`` units."""

    def __init__(self, total: int):
        if total <= 0:
            raise ValueError("ResourceCounter total value must be > 0")
        self._total = total
        self._free = total
        self._tickets: deque[tuple[int, asyncio.Future]] = deque()

    @property
    def total(self) -> int:
        return self._total

    @property
    def available(self) -> int:
        return self._free

    def _admit(self) -> None:
        """Grant queue-head tickets while they fit; stop at the first
        live ticket that doesn't (never skip over it — FIFO)."""
        while self._tickets:
            units, ticket = self._tickets[0]
            if ticket.cancelled():
                self._tickets.popleft()  # swept lazily, nothing to refund
                continue
            if units > self._free:
                break
            self._tickets.popleft()
            self._free -= units
            ticket.set_result(None)

    async def acquire(self, count: int) -> None:
        if count > self._total:
            raise ValueError("Requested count is more than total")
        # the fast path must not jump over queued waiters (cancelled
        # tickets remove themselves below, so presence means liveness
        # modulo a not-yet-resumed cancellation — queueing behind one
        # of those is harmless, the next _admit grants immediately)
        if not self._tickets and count <= self._free:
            self._free -= count
            return
        ticket = asyncio.get_running_loop().create_future()
        entry = (count, ticket)
        self._tickets.append(entry)
        try:
            await ticket
        except asyncio.CancelledError:
            if not ticket.cancelled():
                # granted before the cancellation landed: the sweep
                # already debited our units — put them back
                self._free += count
            else:
                # never granted: leave the queue NOW — a dead ticket
                # parked behind a blocked head would otherwise linger
                # until the head is granted (unbounded growth under
                # sustained timeouts)
                try:
                    self._tickets.remove(entry)
                except ValueError:
                    pass  # the sweep already discarded it
            # either way the head may now be unblocked (our refund, or
            # our dead ticket no longer gating the ones behind it)
            self._admit()
            raise

    def release(self, count: int) -> None:
        if self._free + count > self._total:
            raise ValueError("ResourceCounter released more than total")
        self._free += count
        self._admit()

    async def acquire_and_create_task(
        self,
        coro: Coroutine,
        count: int,
        task_group: asyncio.TaskGroup | None = None,
    ) -> asyncio.Task:
        """Tie ``count`` units to the lifetime of a spawned task."""
        spawn = task_group.create_task if task_group else asyncio.create_task
        await self.acquire(count)
        try:
            task = spawn(coro)
        except BaseException:
            self.release(count)
            raise
        task.add_done_callback(lambda _: self.release(count))
        return task
