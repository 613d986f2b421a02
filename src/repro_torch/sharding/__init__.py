from .fl import (CLIENTS_AXIS, CLUSTERS_AXIS, axis_names, check_clients_mesh,
                 client_shard_count, client_shard_index, clients_axis_size,
                 make_clients_mesh, make_hierarchy_mesh, mesh_client_axes,
                 require_process_group, shard_client_data)
from .specs import (batch_axes, cache_specs, data_specs, param_specs,
                    to_named, to_placements)

__all__ = ["CLIENTS_AXIS", "CLUSTERS_AXIS", "axis_names", "check_clients_mesh",
           "client_shard_count", "client_shard_index", "clients_axis_size",
           "make_clients_mesh", "make_hierarchy_mesh", "mesh_client_axes",
           "require_process_group", "shard_client_data",
           "param_specs", "data_specs", "cache_specs", "batch_axes", "to_named",
           "to_placements"]
