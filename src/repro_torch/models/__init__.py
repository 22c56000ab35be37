"""The paper's experiment models (the MLP classifier) and the llama-family
decoder, dense or with a mixture of experts: init, forward, loss and the
cached one-token decode."""
