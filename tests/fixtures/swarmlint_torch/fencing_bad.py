"""Fixture: unfenced proposals and a fencing-blind proposer (must fire)."""


class Committer:
    def flush(self, store, tasks):
        # leader-path bulk commit without an epoch pin
        return store.bulk_update_tasks(tasks, on_missing=None)

    def commit_block(self, store, olds, nids, state, msg):
        return store.commit_task_block(olds, nids, state, msg)

    def propose(self, proposer, actions, cb, epoch=None):
        # async proposal that drops the epoch on the floor
        return proposer.propose_async(actions, cb)


class BlindProposer:
    def propose_async(self, actions, commit_cb=None):
        """No epoch parameter: cannot participate in fencing."""
        raise NotImplementedError
