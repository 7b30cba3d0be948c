from morphganformer_tpu_torch.parallel.launch import (  # noqa: F401
    free_port,
    initialize_distributed,
    is_main_process,
    local_device,
    spawn_local,
)
from morphganformer_tpu_torch.parallel.mesh import (  # noqa: F401
    DataMesh,
    data_sharding,
    make_data_mesh,
    replicated,
)
from morphganformer_tpu_torch.parallel.tp import (  # noqa: F401
    DataModelMesh,
    make_mesh,
    shard_params,
    unshard_params,
)
