"""Training: optimizers, learning-rate schedules and the QAT + FCP
trainer of the JSC MLPs."""
