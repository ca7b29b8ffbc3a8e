"""Worked examples of the port: ``full_workflow`` runs the five workloads
end to end on synthetic data (``examples/full_workflow.py``'s
counterpart)."""
