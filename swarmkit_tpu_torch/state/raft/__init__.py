from .core import RaftCore
from .node import NotLeader, ProposalDropped, RaftNode
from .storage import DecryptionError, Encoder, KeyEncoder, RaftLogger
from .transport import LocalNetwork

__all__ = ["DecryptionError", "Encoder", "KeyEncoder",
           "LocalNetwork", "NotLeader",
           "ProposalDropped", "RaftCore", "RaftLogger", "RaftNode"]
