"""Online caption serving: the engine, the schedulers (the shape-ladder
``MicroBatcher``, the single-engine slot loop ``ContinuousBatcher`` and
the multi-replica ``ReplicaSet``), caches, metrics, the HTTP front end,
seeded fault injection with the recorded-trace soak (``chaos``) and the
elastic autoscaler (``autoscaler``)."""

from cst_captioning_torch.serving.batcher import (  # noqa: F401
    BackpressureError,
    ContinuousBatcher,
    DeadlineExceededError,
    MicroBatcher,
    ShuttingDownError,
)
from cst_captioning_torch.serving.autoscaler import (  # noqa: F401
    AutoscaleConfig,
    Autoscaler,
)
from cst_captioning_torch.serving.chaos import (  # noqa: F401
    FAULT_SITES,
    ChaosEngine,
    RecordedRequest,
    SoakReport,
    make_diurnal_trace,
    run_soak,
)
from cst_captioning_torch.serving.engine import InferenceEngine  # noqa: F401
from cst_captioning_torch.serving.metrics import (  # noqa: F401
    PRIORITIES,
    ServingMetrics,
)
from cst_captioning_torch.serving.replicas import (  # noqa: F401
    NoHealthyReplicasError,
    ReplicaSet,
    Router,
)
from cst_captioning_torch.serving.server import CaptionServer  # noqa: F401
from cst_captioning_torch.serving.slots import SlotDecoder, TickHandle  # noqa: F401
