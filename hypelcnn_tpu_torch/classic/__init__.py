"""Classic-ML baselines without scikit-learn: a random forest and an RBF
support vector classifier that grow and solve on the card, scikit-learn's
classification metrics, its stratified splitter and a grid search, for
``apps/classic_ml_trainer.py``."""
