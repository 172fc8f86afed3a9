from .placement import (partition_graph_for_mesh, partition_embedding_rows,
                        place_experts, halo_volume, PlacementResult)
