"""The serving core: the layer between the HTTP server and API surface and
the engine, for many small concurrent dashboard queries over a few hot
datasources.

  * `serve.fusion`: micro-batch fusion; compatible concurrent queries wait
    a few ms for each other and run as one fused execution
    (`Engine.execute_fused`: one captured CUDA graph over resident
    segments, one fetch), each demultiplexed with its own QueryMetrics;
  * `serve.lanes`: priority lanes on admission; cheap TopN and Timeseries
    dashboard queries take an interactive slot pool a large scan cannot
    starve (the pools live on `ResilienceState.lanes`);
  * `serve.result_cache`: a result cache keyed on the per-datasource
    version (`catalog/cache.py`), so identical refreshes never reach the
    card.

`ServingCore` (serve/core.py) owns all three for one TPUOlapContext.
"""

from .core import ServingCore  # noqa: F401
from .fusion import FusionScheduler, shared_row_plan  # noqa: F401
from .lanes import LANE_HEAVY, LANE_INTERACTIVE, classify_native  # noqa: F401
from .result_cache import ResultCache  # noqa: F401
