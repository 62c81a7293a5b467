from repro_torch.common.hashing import bytes_hash, tensor_hash

__all__ = ["bytes_hash", "tensor_hash"]
