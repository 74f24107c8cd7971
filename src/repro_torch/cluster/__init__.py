from repro_torch.cluster.energy_model import (MachineClass, TPU_V5E_CLASSES,
                                              task_profile)
from repro_torch.cluster.executor import ClusterExecutor, ExecutionReport
from repro_torch.cluster.workloads import WorkloadSpec, make_cluster_instance

__all__ = ["MachineClass", "TPU_V5E_CLASSES", "task_profile",
           "ClusterExecutor", "ExecutionReport", "WorkloadSpec",
           "make_cluster_instance"]
