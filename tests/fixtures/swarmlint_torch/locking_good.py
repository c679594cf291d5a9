"""Fixture: the corrected twin — one lock order, blocking work outside."""


class MemoryStore:
    def forward_order(self):
        with self._update_lock:
            with self._lock:
                self.apply()

    def same_order_elsewhere(self):
        with self._update_lock:
            with self._lock:
                self.snapshot()

    def read_then_wait(self, proposer, waiter):
        with self._lock:
            snapshot = self.snapshot()
        proposer.wait_proposal(waiter)       # after release
        return snapshot

    def fetch_then_commit(self, planner, handle):
        out = planner.fetch_group(handle)    # D2H before taking locks
        with self._update_lock:
            with self._lock:
                self.apply(out)

    def propose_under_update_lock(self, proposer, actions, cb, epoch):
        # consensus under the WRITER lock is the sanctioned commit
        # path (writers serialize through consensus by design)
        with self._update_lock:
            proposer.propose(actions, cb, epoch=epoch)

    def serve_linearizable(self, proposer, cb):
        # read barrier FIRST, lock-free; the view takes the lock only
        # per method call afterwards (read_view's sanctioned shape)
        proposer.read_barrier()
        with self._lock:
            return self.snapshot()

    def publish_block(self, block):
        # the commit path publishes the COALESCED block under the lock
        # (O(subscribers) buffering); native fan-out expansion runs on
        # the consumer's thread, after release
        with self._update_lock:
            self.queue.publish(block)
        return block.expand_events()

    def wait_card_then_commit(self, torch, pending, finish_fetch):
        # the port's device waits happen before the locks are taken
        torch.cuda.synchronize()
        rows = finish_fetch(pending)
        with self._update_lock:
            self.apply(rows)
