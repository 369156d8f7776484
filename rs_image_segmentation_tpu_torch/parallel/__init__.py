"""Multi-device execution over ``torch.distributed`` (counterpart of
``rs_image_segmentation_tpu.parallel``): meshes, collectives, scene,
spatial, leaf and stage parallelism, and the multi-process rehearsal."""

from .mesh import data_sharding, make_mesh, replicated
from .sharded import (halo_map, sharded_forest_predict,
                      sharded_hierarchical_stack, sharded_kmeans_fit_predict)
