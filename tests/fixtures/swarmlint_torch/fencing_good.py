"""Fixture: the corrected twin — every proposal threads its epoch."""


class Committer:
    def flush(self, store, tasks, epoch):
        return store.bulk_update_tasks(tasks, on_missing=None,
                                       epoch=epoch)

    def commit_block(self, store, olds, nids, state, msg, epoch):
        return store.commit_task_block(olds, nids, state, msg,
                                       epoch=epoch)

    def propose(self, proposer, actions, cb, epoch):
        return proposer.propose_async(actions, cb, epoch=epoch)

    def forward(self, proposer, *args, **kwargs):
        # **kwargs forwarding threads whatever the caller pinned
        return proposer.propose_async(*args, **kwargs)


class FencedProposer:
    def propose_async(self, actions, commit_cb=None, epoch=None):
        raise NotImplementedError
