"""The plain reference: full-graph and per-batch GNN training in plain
PyTorch and f32, written from the graph, the features, the labels and the
weights that the benchmark hands it.  It imports neither JAX, nor the JAX
package, nor anything of the port.

``graph.py`` holds the adjacency and its aggregations, ``train.py`` the
training loop (history caches, the GAS and Reverb steps, the loss, the
clip and Adam, the layer-wise refresh), and one module per model
(``gcn2.py``, ``pna.py``) its layer equations and its operation counts.
"""
