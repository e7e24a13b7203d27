# The paper's evaluations on the port: LoCoMo accuracy and tokens per query
# (`locomo`), and the graph stage's recall (`graph_recall`).
