"""paddle_tpu_torch.analysis: the plan readers of paddle_tpu/analysis/.

Only `jaxplan`'s data half is ported: the committed plan file is read
as JSON. The analyzers and planners (ptlint, jaxcost, jaxplan's
fitting, jaxshard, jaxnum, lockgraph) trace JAX programs and wait for
torch analogues (ROADMAP Queue 1 item 9).
"""
