from morphganformer_tpu_torch.losses.pixel import (  # noqa: F401
    dssim_loss,
    l1_loss,
    mse_loss,
    psnr,
    psnr_loss,
    ssim,
)
from morphganformer_tpu_torch.losses.stack import build_loss_stack, parse_loss_spec  # noqa: F401
