"""Models of the PyTorch port.

``model_configure`` maps a FashionMNIST model type to (emb_dim E_in, out_dim
E_out), the reference's table (``src/model.py:8-15``; the JAX package's
``models/__init__.py:17``).
"""

model_configure = {
    "Vanilla": (4, 1),
    "MIMO-shuffle-instance": (4, 4),
    "MIMO-shuffle-view": (4, 4),
    "MultiHead": (4, 4),
    "MIMO-shuffle-all": (4, 4),
    "single-model-weight-sharing": (1, 1),
}
