from reseek_tpu_torch.encoder.dss import DSSEncoding, encode_chain, mu_kmers

__all__ = ["DSSEncoding", "encode_chain", "mu_kmers"]
