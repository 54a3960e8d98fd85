"""The paper's primary contribution: on-demand VREs with microservices,
mapped to a pool of CUDA devices (a port of the JAX package's
``repro.core``)."""
from repro_torch.core.vre import VREConfig, VirtualResearchEnvironment  # noqa: F401
from repro_torch.core.registry import (GLOBAL_REGISTRY, ServiceRegistry,  # noqa: F401
                                       ServiceSpec, register_service)
from repro_torch.core.workflow import Workflow  # noqa: F401
from repro_torch.core.scheduler import ClusterScheduler  # noqa: F401
from repro_torch.core.monitoring import Monitor  # noqa: F401
from repro_torch.core.deployment import (CentralizedDeployer,  # noqa: F401
                                         DecentralizedDeployer, ImageCache)
