"""Host milliseconds a campaign step in ``run_episode``'s own work: the span
campaign.step less its child spans (the controller's, campaign.exit_check,
campaign.plant, campaign.outcome), over the campaign.step spans in the
traced window, under the profiler."""

from portbench.core.spans import self_seconds


def read(data):
    steps = sum(1 for name, _, _ in data.host if name == "campaign.step")
    if not steps:
        return None
    return 1e3 * self_seconds(data, lambda name: name == "campaign.step")["campaign.step"] / steps
