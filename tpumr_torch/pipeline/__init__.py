"""The DAG-of-jobs pipeline engine.

Counterpart of ``tpumr/pipeline/__init__.py``:

- :mod:`tpumr_torch.pipeline.graph`: :class:`JobGraph`, the client's
  description of a pipeline (job nodes, dfs and stream edges, loop nodes
  with a round barrier and a convergence predicate) and its wire form;
- :mod:`tpumr_torch.pipeline.pipeline_in_progress`: the master's engine,
  which submits each stage when its upstreams allow;
- :mod:`tpumr_torch.pipeline.handoff`: a reduce's output served over the
  shuffle wire to the next stage's maps, with the committed part files as
  the fallback;
- :mod:`tpumr_torch.pipeline.client`: :class:`PipelineClient` and
  :class:`RunningPipeline`.
"""

from tpumr_torch.pipeline.client import (PipelineClient,  # noqa: F401
                                         RunningPipeline)
from tpumr_torch.pipeline.graph import JobGraph, PipelineError  # noqa: F401
