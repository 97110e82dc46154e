"""Dynamic embeddings (a subset of ``torchrec_tpu/dynamic``): the TCP
key-value store that the elastic commit barrier speaks
(:mod:`~torchrec_tpu_torch.dynamic.tcp_kv`).  The parameter server, its
IO registry and the dynamic vocabularies are ROADMAP A10."""
