from ray_tpu_torch.experimental.channel import Channel, ChannelClosedError

__all__ = ["Channel", "ChannelClosedError"]
