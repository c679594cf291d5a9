from .client import (
    RemoteControlClient, RemoteDispatcherClient, issue_certificate,
    join_raft, renew_certificate,
)
from .raft_transport import TCPRaftTransport
from .server import ManagerServer

__all__ = ["ManagerServer", "RemoteControlClient",
           "RemoteDispatcherClient", "TCPRaftTransport",
           "issue_certificate", "join_raft", "renew_certificate"]
