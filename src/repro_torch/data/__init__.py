from repro_torch.data.synthetic import SyntheticCorpus, make_corpus  # noqa: F401
