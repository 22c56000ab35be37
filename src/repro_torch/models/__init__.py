"""The paper's experiment models (the MLP classifier) and the llama-family
decoder parameters the serving path runs."""
