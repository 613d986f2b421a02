from .fl import (CLIENTS_AXIS, CLUSTERS_AXIS, axis_names, check_clients_mesh,
                 client_shard_count, client_shard_index, clients_axis_size,
                 make_clients_mesh, make_hierarchy_mesh, mesh_client_axes,
                 require_process_group, shard_client_data)

__all__ = ["CLIENTS_AXIS", "CLUSTERS_AXIS", "axis_names", "check_clients_mesh",
           "client_shard_count", "client_shard_index", "clients_axis_size",
           "make_clients_mesh", "make_hierarchy_mesh", "mesh_client_axes",
           "require_process_group", "shard_client_data"]
