"""Trainer shims: counterpart of ``mindtheedge_tpu/training/trainer.py``
(reference ``trainers/{base,common}_trainer.py``).  One ``Experiment`` owns
the loop; ``CommonTrainer`` keeps the reference's
``Trainer(**config.arch).fit(module)`` call shape.  Data parallelism lives
in the step (``parallel/mesh.make_dp_train_step`` under ``torchrun``), so
the reference's distributed trainer is the same trainer (``trainer.py:39``)."""


class CommonTrainer:
    def __init__(self, min_epochs=1, max_epochs=50, validate_first=False,
                 seed=42, **kwargs):
        self.min_epochs = min_epochs
        self.max_epochs = max_epochs
        self.validate_first = validate_first

    def fit(self, experiment):
        """experiment: a ``training.experiment.Experiment``."""
        experiment.config.arch.max_epochs = self.max_epochs
        if self.validate_first and experiment.val_loader is not None:
            if experiment.state is None:
                experiment.initialize_state()
            experiment.validate()
        return experiment.fit()

    def test(self, experiment):
        if experiment.test_loader is None:
            raise ValueError('No test dataset configured')
        return experiment.validate()


HorovodTrainer = CommonTrainer
