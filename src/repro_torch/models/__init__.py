"""Model families of the port: shared blocks, the GNN zoo, DLRM."""
