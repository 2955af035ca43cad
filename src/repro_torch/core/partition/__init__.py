from .multilevel import (balance_report, edge_cut, make_constraints,
                         partition_graph, random_partition)
from .book import (GraphPartition, PartitionBook, TypedPartitionData,
                   build_partitions, build_typed_partition, halo_stats)
from .hierarchical import (HierarchicalPartition, hierarchical_partition,
                           locality_report, split_training_set)

__all__ = [
    "balance_report", "edge_cut", "make_constraints", "partition_graph",
    "random_partition", "GraphPartition", "PartitionBook",
    "TypedPartitionData", "build_partitions", "build_typed_partition",
    "halo_stats", "HierarchicalPartition", "hierarchical_partition",
    "locality_report", "split_training_set",
]
