// Workspaces list + create (reference pages/Workspaces, WorkspaceCreate,
// WorkspaceDetail): quota bundle + PVC-backed storage for a team.
import { api, esc, route, statusCell, t } from "../app.js";

export async function viewWorkspaces(app) {
  const data = await api("/workspace/list");
  const rows = data.workspaceInfos || [];
  app.innerHTML = `
    <div class="panel">
      <div class="row"><h2 style="margin:0">${esc(t("workspaces.title"))}</h2>
        <span style="flex:1"></span>
        <a href="#/workspace-create">
          <button class="primary">${esc(t("workspaces.create"))}</button></a>
      </div>
      <table><thead><tr><th>Name</th><th>Owner</th><th>Namespace</th>
        <th>Status</th><th>Storage</th><th>PVC</th><th>Created</th><th></th>
      </tr></thead><tbody>
        ${rows.map(w => `<tr>
          <td>${esc(w.name)}</td><td>${esc(w.username)}</td>
          <td>${esc(w.namespace)}</td><td>${statusCell(w.status)}</td>
          <td class="muted">${w.storage ? esc(w.storage) + "Gi" : ""}</td>
          <td class="muted">${esc(w.pvc_name)}</td>
          <td class="muted">${esc(w.create_time)}</td>
          <td><button class="danger" data-del="${esc(w.name)}">
            ${esc(t("jobs.delete"))}</button></td>
        </tr>`).join("")}
      </tbody></table>
      ${rows.length ? "" : `<p class="muted">no workspaces yet</p>`}
    </div>`;
  app.querySelectorAll("[data-del]").forEach(btn => btn.onclick = async () => {
    await api(`/workspace/${encodeURIComponent(btn.dataset.del)}`,
              { method: "DELETE" });
    route();
  });
}

export async function viewWorkspaceCreate(app) {
  app.innerHTML = `
    <div class="panel"><h2>${esc(t("workspaces.create"))}</h2>
      <div class="form-grid">
        <label>Name</label><input id="w-name" placeholder="team-a">
        <label>Namespace</label><input id="w-ns" value="default">
        <label>Owner</label><input id="w-user" placeholder="username">
        <label>Storage (Gi)</label>
        <input id="w-storage" type="number" min="1" value="10">
        <label>Mount path</label>
        <input id="w-path" value="/workspace">
        <label>Description</label><input id="w-desc">
      </div>
      <div class="row">
        <button class="primary" id="w-go">${esc(t("submit.create"))}</button>
        <span id="w-msg" class="muted"></span>
      </div>
    </div>`;
  document.getElementById("w-go").onclick = async () => {
    const msg = document.getElementById("w-msg");
    const name = document.getElementById("w-name").value.trim();
    if (!name) { msg.textContent = "name is required";
                 msg.className = "error"; return; }
    try {
      await api("/workspace/create", { method: "POST", body: JSON.stringify({
        name,
        namespace: document.getElementById("w-ns").value || "default",
        username: document.getElementById("w-user").value,
        type: "pvc",
        storage: parseInt(document.getElementById("w-storage").value || "1"),
        local_path: document.getElementById("w-path").value,
        description: document.getElementById("w-desc").value,
      }) });
      location.hash = "#/workspaces";
    } catch (e) { msg.textContent = e.message; msg.className = "error"; }
  };
}
