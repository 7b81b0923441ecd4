"""Package logging.

The standard `logging` module under the `spark_druid_olap_tpu_torch`
namespace; nothing configures the root logger (library etiquette), so output
appears only when the application enables it:

    import logging
    logging.getLogger("spark_druid_olap_tpu_torch").setLevel(logging.DEBUG)
    logging.basicConfig()

Conventions: plan/rewrite decisions -> DEBUG; per-query completion -> INFO.
"""

from __future__ import annotations

import logging


def get_logger(name: str) -> logging.Logger:
    """Child logger under the package namespace: get_logger("plan.planner")
    -> "spark_druid_olap_tpu_torch.plan.planner"."""
    return logging.getLogger(f"spark_druid_olap_tpu_torch.{name}")
