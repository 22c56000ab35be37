"""The paper's experiment models (the MLP classifier) and every
architecture of the config registry (attention, MLA, recurrent and
encoder-decoder blocks, dense or with a mixture of experts): init,
forward, loss and the cached one-token decode."""
