from morphganformer_tpu_torch.ops.bias_act import activation_funcs, bias_act  # noqa: F401
from morphganformer_tpu_torch.ops.conv2d_resample import conv2d_resample  # noqa: F401
from morphganformer_tpu_torch.ops.fused_conv import (  # noqa: F401
    downconv2_plain,
    fused_downconv2,
    fused_modconv3x3,
    fused_upconv2,
    launch_counts,
    modconv3x3_plain,
    reset_launch_counts,
    upconv2_plain,
)
from morphganformer_tpu_torch.ops.conv3x3 import conv3x3_same, conv3x3_same_plain  # noqa: F401
from morphganformer_tpu_torch.ops.modulated_conv import modulated_conv2d  # noqa: F401
from morphganformer_tpu_torch.ops.packed_override import force_unpacked  # noqa: F401
from morphganformer_tpu_torch.ops.second_order import (  # noqa: F401
    reg_stage_second_order,
    second_order_scope,
)
from morphganformer_tpu_torch.ops.upfirdn2d import (  # noqa: F401
    downsample2d,
    nearest_neighbors_kernel,
    setup_filter,
    upfirdn2d,
    upsample2d,
)
