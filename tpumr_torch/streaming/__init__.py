"""Streaming: any executable that reads records on stdin and writes them
on stdout as a mapper, reducer or combiner.

Counterpart of ``tpumr/streaming/`` (``pipe_runner``, ``stream_job``,
``typedbytes``).
"""

from tpumr_torch.streaming.pipe_runner import (StreamCombiner,
                                               StreamMapRunner,
                                               StreamReducer)
from tpumr_torch.streaming.stream_job import StreamJob, setup_stream_job

__all__ = ["StreamMapRunner", "StreamReducer", "StreamCombiner",
           "StreamJob", "setup_stream_job"]
