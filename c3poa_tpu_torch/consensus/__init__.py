from .vote import vote_consensus, record_for_draft
from .engine import (
    ConsensusJob,
    ConsensusParams,
    consensus_many,
    consensus_read,
    zero_repeat_consensus,
)
