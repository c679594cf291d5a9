"""Fixture: lock-order cycle + blocking work under store locks (fires)."""


class MemoryStore:
    def forward_order(self):
        with self._update_lock:
            with self._lock:
                self.apply()

    def reverse_order(self):
        # opposite nesting of forward_order: a lock-order cycle
        with self._lock:
            with self._update_lock:
                self.apply()

    def read_then_wait(self, proposer, waiter):
        with self._lock:
            proposer.wait_proposal(waiter)   # consensus under view lock

    def commit_with_fetch(self, planner, handle):
        with self._update_lock:
            planner.fetch_group(handle)      # D2H under the writer lock

    def serve_linearizable_locked(self, proposer):
        with self._lock:
            proposer.read_barrier()          # barrier wait under view lock

    def publish_block_expanded(self, hp, block, status, event_cls):
        # GIL-released native fan-out under the WRITER lock: the watch
        # synthesis belongs on consumer threads, never the commit path
        with self._update_lock:
            hp.fanout_expand(block.olds, block.node_ids,
                             block.base_version, block.ts, status,
                             event_cls)

    def wait_card_locked(self, torch, pending, finish_fetch):
        # the port's device waits under the store locks
        with self._lock:
            torch.cuda.synchronize()         # a card sync under view lock
        with self._update_lock:
            finish_fetch(pending)            # D2H wait under writer lock
